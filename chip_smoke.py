"""Drive the PyTorch port's serving and training paths on one CUDA card
and check them.

Run from the repository root with no arguments::

    python3 chip_smoke.py

or, to also time the paged kernels' decode calls (the standard decode
entry, the deep kernel and ``flash_decode``) and the flash-attention
forward of a parent tree against this one in the same run, with a tree
unpacked from ``git archive`` of the parent commit (each side runs
``areal_tpu_torch/tools/kernel_ab.py`` in its own process, in turns
parent, change, change, parent)::

    python3 chip_smoke.py --parent PATH

It builds the port's CUDA kernels from ``areal_tpu_torch/csrc`` (into
``areal_tpu_torch/_build/``, one nvcc per source, in parallel), then, at
the full width and depth of the Qwen2.5-1.5B architecture (random weights
from a seed, float32 master weights and their bf16 serving copy):

1. holds the paged-attention kernels against their plain PyTorch version
   at the serving paths' shapes: the standard kernel on bf16 and int8
   pools at decode and prefill-chunk shapes (a prefill chunk runs its
   tensor-core entry: 8 rows of Q=512, and one row of Q=512 after a
   31000-token prefix, and 4 rows of Q=512 after prefixes of 1000, 1255,
   257 and 0 tokens, ending mid-page, and a speculative verify window:
   8 rows of Q=8 over prefixes of mixed lengths), the deep kernel on both
   pools at the prefill-chunk shape and at decode over 16 rows of up to
   32768 tokens (lengths 0, 1, BS-1, BS, BS+1, full and between; each
   deep call logs the body it runs, tensor cores or CUDA cores, and its
   copy route), the decode entry and the deep kernel on float32 and
   float16 q and pools, and ``flash_decode`` over a contiguous 16 x 32768
   cache beside ``scaled_dot_product_attention`` on the same rows (its
   backend logged); repeats every call
   (a decode call with key splits among them) and requires the repeat
   bit-identical; times the decode entry L2-cold (cycling over enough pool
   layers that the bytes it reads between two calls on one layer exceed
   twice the L2); times the standard and deep kernels at decode for
   contexts 4096-32768 and at the 8-row shape, and prints the dispatch
   threshold those times support;
2. serves requests through ``ContinuousBatchingEngine`` (a greedy wave of
   8 requests, resubmission, weight swaps, a sampled wave at two pipeline
   depths, chunked prefill, and profiles of one decode chunk and of one
   prefill chunk after a short and after a 31000-token prefix);
3. serves the async-PPO recipe's configuration (16 rows, 32768-token KV,
   a wave of 14 prompts of 512 tokens and 2 of 8000 and 31000) in three
   arms: a bf16 pool on the default dispatch table, a bf16 pool routing
   decode chunks past 8192 tokens to the deep kernel, and an int8 pool
   with that table; checks each arm's kernel launches against the
   dispatched work, its leak audit and its logprobs against the trainer
   forward, and serves a deliberately broken int8 arm (V scales doubled)
   that the gate must fail;
4. holds the flash-attention forward and backward kernels against their
   plain version on packed, long and ragged rows (T from 32 to 16384, not
   always a multiple of a tile) at Qwen2.5-1.5B's heads, at Gemma-2B's
   (head_dim 256, 8 query heads on 1 KV head) and at Mistral-7B's with
   its window of 4096 (and small windows over ragged rows), with a
   bit-identical repeat of the forward and backward and, for a window, a
   control (the kernel without the window) that must fail, and times
   them on the packed and long rows of each beside
   ``torch.nn.functional.scaled_dot_product_attention`` (a boolean mask)
   as a yardstick, the backward also by part (D, dq, dk/dv with its
   reduction);
5. serves the recipe's group traffic through the radix prefix cache, on a
   bf16 pool and on an int8 pool, with keyed sampling at temperature 1
   (16 rows, 32768-token KV): a group of 16 over one 1000-token prompt
   (one prefill, 15 copied tail blocks), one round of continuations that
   resume parked rows (no prefill), a second group over the first prompt
   plus 500 tokens (only the suffix prefilled) through two weight swaps
   (the cache flushed, the shared blocks recomputed, bit-identical from
   one swap to the next), and a pressure arm with a quarter of the dense
   pool (4096 tokens for 8 x 2048) that preempts and completes every
   request; launches against the dispatched work, logprobs against the
   trainer forward, and the leak audit on every path;
6. runs one async-PPO trainer iteration on the greedy wave's rollout
   through ``PPOActorInterface`` (actor_inf, then three actor_train steps
   with AdamW), with the recipe's settings but ``max_tokens_per_mb=2048``
   (so a minibatch accumulates over micro-batches), lr 1e-4 and no
   warm-up (so three steps move the bf16-cast weights), then swaps the
   trained weights into a serving engine and checks its logprobs against
   the trainer's.  Deliberately broken trainer forwards (controls) show
   that the logprob gate would fail them;
7. publishes phase 6's trained weights as version 1 (a bf16 snapshot
   written on a background thread, then its manifest) and serves the
   recipe's group traffic (16 requests over one 1000-token prompt,
   temperature 1, 384 new tokens) through ``GenerationServerWorker`` over
   ZMQ at the GenServerConfig defaults with the recipe's 16 rows and
   32768-token KV, its engine at version 0 from the same seed: it stages
   v1 while the group decodes (the server's poll loop must enqueue decode
   steps while its stage thread restores; the staged tree must be
   bit-identical to the serving copy of the published weights), then
   pauses, commits and resumes as the gserver manager does, acknowledges
   a repeated commit, continues every answer under v1, and refuses a
   snapshot whose manifest alters one leaf's shape before reading any
   tensor.  Every token's
   version, the logprobs of v0 and v1 tokens against the trainer forward
   of each version, the paged launches against the engine's work, the
   SLO digests and swap counters of the metrics reply, and the leak audit
   are checked; it prints the publish, stage and pause seconds;
   then the HF phase (``hf_phase``) writes the seeded weights as a bf16
   ``Qwen2ForCausalLM`` directory (one ``model.safetensors``, written with
   ``safetensors.torch``), loads it through ``make_model(type_="hf")``
   (bit-identical to the seeded weights cast to bf16), and has a server on
   other weights stage, commit and serve it (``format: "hf"``; the staged
   and the served tree bit-identical to the directory's, launches against
   the work, logprobs against the trainer forward, the leak audit); then
   the sync-PPO phase (``sync_ppo_phase``) runs ``PPOMathExperiment``
   from the recipe's ``training/configs/sync_ppo.yaml`` with the critic
   and the reference model (``ppo.disable_value=false``,
   ``ppo.kl_ctl=0.1``) through ``run_experiment_local``, 2 steps of 16
   sequences and 256 new tokens (SYNC_*), all three models loaded from
   the HF directory: the 7-MFC graph, generation over the dense KV cache
   (decode through ``flash_decode``, the prefill of the empty cache
   through the flash kernel), the critic from a zero value head; it gates
   the launches of each generation against the decode steps and prefills
   the loop counted, the run's flash launches against its micro-batches,
   step 1's KL, the critic's values, actor_inf's logprobs against the
   generation's, and ``flash_decode`` at the phase's cache shape against
   its plain version, and prints generation tokens/s, each MFC's seconds,
   the step walls and the peak memory;
8. runs the whole async-PPO loop through the port's entry point:
   ``AsyncPPOMathExperiment`` through ``run_experiment_local`` (a
   generation server, the gserver manager, two rollout workers running the
   math single-step agent and environment, the master, and a model worker
   that hosts the actor, runs actor_inf and actor_train and publishes each
   version with its int8 sibling, which the manager stages and commits into
   the server), with the recipe's ``actor.type_: hf`` on the HF phase's
   directory (trainer and server both load it) and ``save_freq_steps`` at
   its last step (the HF save must name ``Qwen2ForCausalLM`` and reload
   bit-identical to the trainer's final weights), at the recipe's
   settings with the ASYNC_* cuts and the LOOP_* cuts (one group of
   32-token answers a step, 2 steps, no head offpolicyness, so that
   step 2's group waits for the manager's swap of step 1's version), on a
   word-level tokenizer of the model's 151936 words and 64 math rows; it
   prints which of transformers, tokenizers, zmq and safetensors import,
   and gates the master's steps, the server's version (through the
   manager's swaps), every consumed trajectory's staleness and token
   versions, every published manifest and its int8 sibling, the served
   weights against the published snapshot, actor_inf's logprobs against
   the server's, the paged and flash launches against the dispatched work,
   and the leak audit;
9. runs phase 8's experiment at the ASYNC_* settings, cut to 3 steps of
   one group of 64-token answers (PROC_TRAIN_BS, PROC_NEW_TOKENS), as one
   process per worker through the
   port's launcher (``launch_experiment(mode="local",
   recover_retries=1)``: the master, the model worker, the generation
   server, the gserver manager and two rollout workers), with a recover
   checkpoint at step 2 and the HF save at step 3; once the master's
   recover info is on disk it SIGKILLs the model worker's process, and the
   launcher's restart policy relaunches every process with
   ``AREAL_RECOVER=1``.  Each worker process runs :func:`process_probe`;
   the gates read across the process boundary (the master's
   ``stats.jsonl``, the device processes' counters files, the probes'
   lines, the snapshots and the HF save on disk): the steps (exactly one
   after the restart), the recover (``recover_load`` of ``globalstep2``,
   the restored train state's checksums equal to what step 2 wrote), the
   served version and weights, token versions and staleness, the HF
   save, logprobs, each device process's launches against its own work,
   only the model worker and the server holding the card
   (``nvidia-smi``), and no worker process left; it prints step walls,
   ``actor_train``, the trainer's wait, decode tokens/s, publish, stage,
   pause, restart and checkpoint seconds and each process's peak memory.

Between the sync-PPO phase and phase 8, the training phase
(``training_phase``) runs ``SFTExperiment`` from the recipe's
``training/configs/sft.yaml`` (8 sequences of up to 4096 tokens in
micro-batches of 16384, once in rows of the longest sequence for 3 steps
and once in rows packed to 16384 tokens for 2: step 1's first micro-batch
against the plain attention, the loss falling on the repeated batch),
``DPOExperiment`` from ``training/configs/dpo.yaml`` (the actor and its
frozen reference, step 1's loss at ln 2) and ``RMExperiment`` (``rw``, a
critic with a zero value head) through ``run_experiment_local``, all from
the HF directory at full width and depth, gating every MFC's flash
launches against its micro-batches; then, at 4 layers on one 16384-token
row, one step under each remat policy (its gradient norm against
``none``'s, its peak memory and step time) and two steps each of float32
Adam, bf16 ``mu``, bf16 ``nu`` and the factored second moment
(``opt_state_bytes``, the second update against float32 Adam's).  After
it, the family phase (``family_phase``) runs ``SFTExperiment`` two steps
each on Gemma-2B's published widths (18 layers, head_dim 256, one packed
row of 8192 tokens) and on Mistral-7B-v0.1's (2 layers, window 4096, one
packed row of 16384 tokens whose segments outrun the window), each from
an HF directory the port's ``save_hf_model`` wrote from seeded weights,
with the route check against the plain attention and a control that must
fail it (rows as one segment; the attention without the window), and one
greedy generation of the Mistral configuration through ``decode_step``'s
window gather after a 6000-token prompt.  The
long-context, prefix-cache and generation-server phases serve the model's
first CUT_LAYERS layers, and the sync-PPO phase and phases 8 and 9 load a
copy of the HF directory cut to them.

The engines of phases 2-6 run without the SLO records, and those of
phases 2, 3 and 6 without the prefix cache, so their work counts and
times stay comparable with an engine that has neither.
Every phase raises on failure, so the script exits non-zero.  It exits
non-zero without printing a result when no CUDA card is present, or when
the ``areal_tpu_torch`` package is not beside it.

Output, in order: the card (``nvidia-smi`` name and power limit), the
builds, each phase's comparisons, throughput and checks, then on the last
three lines the card again, one ``{"kernels": [...]}`` JSON line, and the
final ``{"ok": true, "device": {...}}`` JSON line.

All float32 matrix products here run in full float32
(``torch.backends.cuda.matmul.allow_tf32 = False``), so the plain
versions are exact float32 references.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

SEED = 0
PAGE_SIZE = 256
MAX_BATCH = 8
KV_CACHE_LEN = 4096
PREFILL_CHUNK = 512
CHUNK_SIZE = 16
PIPELINE_DEPTH = 2
NEW_TOKENS = 128
#: the resubmitted greedy wave's tokens, held to the first wave's heads
RESUBMIT_TOKENS = 32
#: the sampled waves compare their streams at two pipeline depths: 16
#: tokens a request (8 x 16 positions) keep the script inside its time
SAMPLED_NEW_TOKENS = 16
#: prompt lengths of the 8 requests: spread over 300-3000 tokens, crossing
#: page (256) and prefill-chunk (512) boundaries
PROMPT_LENS = (300, 3000, 777, 1536, 513, 2049, 1023, 2600)

#: the long-context serving phase: the async-PPO recipe's generation
#: settings (training/configs/async_ppo.yaml: gen_max_concurrent_batch 16,
#: gen_kv_cache_len 32768), 14 prompts at half the recipe's prompt cap
#: and 2 long ones (46168 prompt tokens), 16 new tokens each (the prompts
#: of 16000 and 24000 tokens, three quarters of the new tokens and half of
#: each short prompt were cut for the script's time: 16 decode chunks a
#: wave, from 32; the 31000-token row still decodes on the deep kernel in
#: arms B and C)
LONG_MAX_BATCH = 16
LONG_KV_CACHE_LEN = 32768
LONG_PROMPT_LENS = (512,) * 14 + (8000, 31000)
LONG_NEW_TOKENS = 16
#: the deep-kernel threshold of arms B and C
DEEP_MIN_CONTEXT = 8192
#: (arm, kv_cache_dtype, deep_min_context); None keeps the default table
LONG_ARMS = (("A", "auto", None), ("B", "auto", DEEP_MIN_CONTEXT),
             ("C", "int8", DEEP_MIN_CONTEXT))
#: prompts of the broken int8 control wave and their new tokens (32
#: before the cut for the script's time: 6 decode chunks, from 12)
LONG_CONTROL_LENS = (1024,) * 4 + (8000, 16000)
LONG_CONTROL_NEW_TOKENS = 16
#: contexts at which the standard and deep kernels are timed at decode
DISPATCH_CONTEXTS = (4096, 8192, 16384, 32768)
#: the prefix-cache phase, at the recipe's serving shape (max_batch 16,
#: kv_cache_len 32768, group_size 16: training/configs/async_ppo.yaml:24):
#: a group of 16 over one prompt of 1000 tokens (not a page multiple, so
#: its tail block is copied per member), 64 new tokens each, then one
#: round of continuations; a second group whose 1500-token prompt starts
#: with the first prompt (a shared system prompt), through two weight
#: swaps once its rows have generated PREFIX_SWAP_AFTER tokens
PREFIX_GROUP = 16
PREFIX_PROMPT = 1000
PREFIX_SUFFIX = 500
PREFIX_NEW_TOKENS = 64
PREFIX_ROUNDS = 1
PREFIX_SHARED_NEW_TOKENS = 96
#: the first sharer's recompute covers the shared blocks in full 512-token
#: chunks of its own once it holds 1500 + 36 tokens
PREFIX_SWAP_AFTER = 40
#: the pressure arm: a quarter of the dense pool (16 pages of 256 against
#: 8 x 2048 tokens) under 8 prompts of 512-1500 tokens, 48 new tokens
#: each; sized for the script's time, it preempts once and gives back one
#: fill, in 18 fill and 19 decode chunks (``tools/prefix_rehearsal.py
#: pressure``; PERF.md section 4 lists the earlier sizes)
PRESSURE_MAX_BATCH = 8
PRESSURE_KV_CACHE_LEN = 2048
PRESSURE_POOL_TOKENS = 4096
PRESSURE_PROMPT_LENS = (512, 1500, 750, 1024, 550, 1450, 888, 1250)
PRESSURE_NEW_TOKENS = 48
#: the generation-server phase: the recipe's group traffic (group_size 16
#: over one 1000-token prompt, temperature 1) with 384 new tokens (the
#: recipe allows 16384), then one continuation round of 64 under the new
#: weights, served by GenerationServerWorker at the GenServerConfig
#: defaults with the recipe's max_concurrent_batch 16 and kv_cache_len
#: 32768 (pages of 1024, decode chunks of 64, prefix cache and SLO
#: records on).  The server reads a command only between steps, and each
#: of the stage, pause and commit RPCs may wait out a 64-step chunk; a
#: group member may run a chunk ahead of the others; so every member
#: needs more than 5 chunks of budget to be in flight when v1 applies: 6
SERVER_NEW_TOKENS = 384
SERVER_CONT_NEW_TOKENS = 64
#: the leaf whose shape the bad-manifest control alters
SERVER_BAD_LEAF = "layers/0/mlp/down/w"
#: the HF phase: the seeded weights written as a Qwen2ForCausalLM
#: directory in bf16 (one model.safetensors, as published checkpoints
#: come), loaded by make_model, and swapped (format "hf", staged) into a
#: server of 4 rows x 4096 tokens that then serves these prompts
HF_SERVER_MAX_BATCH = 4
HF_SERVER_KV_CACHE_LEN = 4096
HF_PROMPT_LENS = (1000, 300, 37, 2048)
HF_NEW_TOKENS = 32
#: the async-PPO phase: AsyncPPOMathExperiment through the port's local
#: runner at the recipe's settings (training/configs/async_ppo.yaml)
#: with these cuts: one card for trainer and server, train_bs_n_seqs 32
#: (recipe 512), max_new_tokens 256 (16384), new_tokens_per_chunk 128
#: (2048: each answer spans two chunks), max_concurrent_rollouts 4 (64),
#: max_tokens_per_mb 2048 (32768), lr 1e-4 without warm-up (1e-6), and
#: benchmark_steps 3; 64 math rows of 200-1000 prompt tokens
ASYNC_ROWS = 64
ASYNC_PROMPT_WORDS = (200, 1000)
ASYNC_MAX_LENGTH = 1024
ASYNC_TRAIN_BS = 32
ASYNC_NEW_TOKENS = 256
ASYNC_CHUNK_TOKENS = 128
ASYNC_MAX_ROLLOUTS = 4
ASYNC_STEPS = 3
ASYNC_OFFPOLICYNESS = 4
#: words of the phase's tokenizer that spell a right answer
#: ("\\boxed{84/2}", "\\boxed{126/3}", ...): 256 tokens drawn uniformly
#: from 151936 hold one with probability 1 - exp(-256 * 300 / 151936) =
#: 0.40, so groups mix rewards 0 and 1 and the advantages are not all 0
ASYNC_ANSWER_WORDS = 300
#: phase 8 (in one process) cut to pay for the processes phase, which runs
#: at the ASYNC_* settings (cut to PROC_*): one group of 32-token answers
#: a step (128 before the sync-PPO phase came, then 64), 2 steps,
#: and no head offpolicyness, so that step 2's group is admitted only once
#: the manager has swapped step 1's version in: the run shows one swap
#: staged and committed while trainer and server share the process
LOOP_TRAIN_BS = 16
LOOP_NEW_TOKENS = 32
LOOP_STEPS = 2
LOOP_OFFPOLICYNESS = 0
#: the sync-PPO phase (the recipe's training/configs/sync_ppo.yaml with the
#: critic and the reference model): 2 steps of 16 sequences (512 in the
#: recipe), 192 new tokens (4096; 256 before the cut for the training
#: phase: 16 answers then miss every right-answer word with probability
#: (1 - 0.316)^16 = 0.2%, and the critic's gate needs a reward), micro-batches
#: of MAX_TOKENS_PER_MB
SYNC_TRAIN_BS = 16
SYNC_NEW_TOKENS = 192
SYNC_STEPS = 2
SYNC_KL_CTL = 0.1
#: decode steps of the sync-PPO generation replayed for its anatomy (32
#: before the cut for the script's time)
ANAT_DECODE_STEPS = 8
#: the processes phase cut from the ASYNC_* 32 sequences of 256-token
#: answers a step to pay for the sync-PPO phase (its 3 steps and its
#: kill-and-resume unchanged)
PROC_TRAIN_BS = 16
PROC_NEW_TOKENS = 64
#: the long-context, prefix-cache and generation-server phases serve the
#: model's first CUT_LAYERS layers, and the sync-PPO phase and phases 8
#: and 9 load a copy of the HF directory cut to them (28 before the cut for the script's
#: time, to pay for the training phase): their host-bound prefill and
#: decode, loads, recover checkpoint and HF save scale with depth; their
#: shapes, widths and gates do not
CUT_LAYERS = 14
#: the training phase (SFT, DPO and reward-model training from the
#: recipes' training/configs/{sft,dpo}.yaml at full width and depth): the
#: recipes' max_length and max_tokens_per_mb, and the row capacity of the
#: packed SFT run
TRAIN_MAX_LENGTH = 4096
TRAIN_MB_TOKENS = 16384
TRAIN_PACK_CAPACITY = 16384
#: SFT: one batch of 8 sequences (64 in the recipe), 16496 tokens in two
#: micro-batches, repeated each epoch; the longest reaches max_length.
#: Step 1's lr is the warm-up's 0, so the third step shows the fall
SFT_LENS = (4096, 3500, 2900, 2300, 1700, 1100, 600, 300)
SFT_STEPS = 3
SFT_PACKED_STEPS = 2
#: the recipe's 2e-5 on a random model moves a 12-nat loss by less than the
#: rounding of two layouts of one batch; 1e-4 shows one update's fall
SFT_LR = 1e-4
#: DPO / rw rows: (prompt words, ((chosen, rejected words), ...)), the
#: recipe's max_pairs_per_prompt 2; the longest sequence reaches max_length
PAIR_ROWS = ((3000, ((1095, 700), (400, 900))),
             (1500, ((800, 1200), (300, 50))),
             (800, ((2000, 1500), (100, 600))),
             (200, ((3000, 1000), (500, 2500))))
DPO_TRAIN_BS = 4  # prompts (32 in the recipe): 16 sequences, 8 pairs
RW_TRAIN_BS = 2
#: the options arm: the architecture's width at 4 layers, one micro-batch
#: of 16384 tokens in one packed row, lr 1e-4 without warm-up
OPTIONS_LAYERS = 4
OPTIONS_LENS = (4096,) * 4
OPTIONS_LR = 1e-4
#: steps per remat policy in the options arm: the first carries first use
REMAT_STEPS = 2
#: cached prefixes of the mid-page prefill-entry case: a cache hit leaves
#: a fill's start anywhere in a page
MID_PAGE_PREFIXES = (1000, 1255, 257, 0)
# the cached prefixes of a verify window's rows in the kernel phase: a row
# sitting the window out (0), prefixes inside the first page, at and past
# a page's end, mid-page and up to the longest a 4096-token row can verify
VERIFY_PREFIXES = (0, 1, 255, 257, 777, 1544, 3017, 4088)
#: the cached prefix of the long prefill-chunk shape (the long wave's
#: largest prompt is 31000 tokens)
LONG_PREFILL_PREFIX = 31000

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
# The serving-features phase: int8 serving weights, speculative decoding,
# the prefix cache's host tier and the dense cache, on the CUT_LAYERS copy
# of the HF directory at 8 rows x 4096 tokens of KV
FEAT_PROMPT_LENS = (300, 1000, 777, 513, 640, 900, 450, 1024)
FEAT_NEW_TOKENS = 48
SPEC_MAX_DRAFT = 7
# two full pages and one token: a match stops at a page boundary
SPILL_PROMPT = 2 * PAGE_SIZE + 1
SPILL_NEW_TOKENS = 16
SPILL_POOL_BLOCKS = 32
DENSE_KV_CACHE_LEN = 2048
DENSE_PROMPT_LENS = (300, 1500, 777, 1024, 513, 1200, 900, 1100)
DENSE_NEW_TOKENS = 64
# the Mistral-7B-v0.1 configuration cut to 2 layers, a prompt past its
# 4096-token window
MISTRAL_LAYERS = 2
MISTRAL_PROMPT = 6000
MISTRAL_KV_CACHE_LEN = 8192
MISTRAL_NEW_TOKENS = 48
#: the family phase (``family_phase``): SFT of Gemma-2B's widths (all 18
#: of its layers) on one packed row of 8192 tokens, and of
#: Mistral-7B-v0.1's widths at MISTRAL_LAYERS layers on one packed row of
#: 16384 whose segments are longer than its window of 4096, two steps
#: each; then one short greedy generation of the Mistral configuration
#: through the dense cache's ``decode_step`` (the window gather) after a
#: prompt longer than the window
GEMMA_LAYERS = 18
GEMMA_SFT_LENS = (3000, 2500, 1500, 1192)
MISTRAL_SFT_LENS = (9000, 5000, 2384)
FAMILY_SFT_STEPS = 2
WINDOW_GEN_PROMPT = 6000
WINDOW_GEN_NEW = 16
# int8 against bf16 serving weights: |teacher-forced logprob gap| on the
# bf16 engine's greedy tokens (mean, max), about 3x the sound readings on
# an H100 (8.149e-4 / 3.908e-3, and 1.391e-3 / 3.917e-3 on other greedy
# tokens: the bf16 stream itself moves between processes at near-ties).
# The control, every int8 scale W8_DRIFT_CONTROL times too large, read
# 1.627e-2 / 4.693e-2 and 1.814e-2 / 5.086e-2, about 4x above.  This gate
# bounds the drift that quantization adds; it cannot see a small
# mis-scale (one step, 1/127: 9.878e-4; one scale a matrix or the scales
# in reversed channel order: 8.251e-4 / 8.300e-4), which the exact
# dequantization gate below catches (tools/w8_controls.py; PERF.md
# section 6, PR 15)
TOL_W8_MEAN = 4e-3
TOL_W8_MAX = 1.2e-2
W8_DRIFT_CONTROL = 1.25
# the exact dequantization gate's control: every scale one step too large,
# which moved the teacher-forced logprobs by 7.336e-4 / 3.906e-3 and
# 1.091e-3 / 7.812e-3 (mean, max) against the host's dequantization,
# where the sound tree reads 0
W8_STEP_CONTROL = 1 + 1 / 127
# the window-gather decode of the Mistral configuration against the
# windowed forward (mean, max).  Before the flash kernel took the window,
# that forward was masked dense attention on the card, which rounds its
# probabilities to bf16 before the product with V over ~4096 keys: 2.947e-3
# / 1.566e-2, and the same forward without the window 0.385 / 0.948, which
# must fail these; now it is the flash kernel with the window (the family
# phase's decode_step read 1.978e-3 / 1.562e-2, its no-window control
# 0.251 / 0.430)
TOL_WINDOW_MEAN = 1e-2
TOL_WINDOW_MAX = 5e-2

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

# kernel-vs-plain tolerances: both sides compute in float32 from the
# same bf16 inputs and differ only in summation order
TOL_OUT = 2e-4  # max |acc/l - ref| (outputs are O(1) averages of V rows)
TOL_M = 1e-4  # max |m - ref| (scores are O(1) after the 1/sqrt(hd) scale)
TOL_L_REL = 1e-4  # max |l - ref| / max(1, |ref|)
#: relative L2 distance allowed between chunked and one-chunk prefill
#: logits: bf16 activations round at other places when the prefix is read
#: back from the pool through the kernel instead of attended in-chunk
TOL_CHUNKED_LOGITS = 3e-2
#: mean and max |serving logprob - trainer recompute| allowed over the
#: generated tokens of one rollout at the same weights.  The two bf16
#: forwards round at other places (chunked paged prefill and the f32 paged
#: kernel against one packed pass through the flash kernel, which rounds P
#: to bf16).  Set on an H100 between the sound readings (largest: mean
#: 1.2e-3, max 3.9e-3) and the weakest broken control, the trainer forward
#: without RoPE (mean 9.4e-3, max 2.2e-2): each gate is 2.2-3.1x from
#: both.  The random init gives near-uniform logits (the tied embedding's
#: entries are uniform in +-1/sqrt(151936), so logits have a standard
#: deviation near 0.06), so a fault moves logprobs by hundredths.
TOL_PROX_MEAN = 3e-3
TOL_PROX_MAX = 1e-2
#: the same gate for the long-context arm served from an int8 pool, whose
#: storage rounding adds to the bf16 roundings.  Read on an H100: the int8
#: arm mean 5.7e-4, max 3.9e-3 (the bf16 arms 4.7e-4, 3.9e-3); a
#: deliberately broken int8 arm (V dequantized at twice its scale) mean
#: 1.3e-2, max 4.1e-2.  Each limit is 2.6-5.3x above the int8 reading and
#: 4.1-4.4x below the control's; the script serves the control and fails
#: if this gate does not see it
TOL_INT8_MEAN = 3e-3
TOL_INT8_MAX = 1e-2

# flash-attention kernel vs plain version.  The kernels multiply bf16
# operands on the tensor cores with f32 accumulation and round P and dS to
# bf16 before their products (as the TPU kernel does); the plain version
# is f32 throughout on the same bf16 inputs.
#: relative L2 distance of out over real tokens: out is stored in bf16
#: (relative rounding error up to 2^-9), and P is rounded to bf16 before
#: the P.V product.  Read on an H100: 1.8e-3 to 2.1e-3 on every layout
TOL_FA_OUT = 1e-2
#: the largest relative L2 distance of one real token's out [Hq, hd]: an
#: error confined to a few tokens or a tile edge shows here, not in the
#: distance over all tokens.  Read on an H100: 2.2e-3 to 2.5e-3
TOL_FA_OUT_TOKEN = 2e-2
#: max |lse - ref|: f32 softmax statistics over f32-accumulated scores
TOL_FA_LSE = 1e-4
#: relative L2 distance of dq, dk, dv (bf16 internals; the verify notes'
#: ~2e-2 for gradients)
TOL_FA_GRAD = 2e-2
#: the kernels against the plain attention on a train step's first
#: micro-batch at full depth (train_route_check): the largest relative L2
#: distance of one real token's final hidden state, and the largest
#: |logprob - plain| of a transition.  Float32 weights, bf16 activations;
#: the kernels round P to bf16.  Read on an H100 at 28 layers (rows of 4096
#: and of 16384): 1.41e-2 to 1.42e-2 and 2.7e-3 to 3.1e-3; the control,
#: the kernels given each row as one segment, 1.47 to 1.51 and 0.31 to
#: 0.38.  Each limit is 3.3-3.5x above the sound reading and 29-31x below
#: the control's; the script runs the control in both SFT runs and fails
#: if a gate does not see it
TOL_TRAIN_HIDDEN = 5e-2
TOL_TRAIN_LOGPROB = 1e-2
#: the logprob gate of the family phase's route checks.  A logprob's error
#: is about the hidden state's relative error times the logits' scale:
#: Mistral's untied random head (uniform in +-1/sqrt(4096)) gives logits of
#: standard deviation near 0.58 over unit-RMS hidden states, ~10x the tied
#: embeddings' of Qwen and Gemma (uniform in +-1/sqrt(V): near 0.05-0.06),
#: against which TOL_TRAIN_LOGPROB was set.  Read on an H100 (the family
#: phase's first run):
#: Mistral's kernels 6.98e-3 hidden (under TOL_TRAIN_HIDDEN, which stays)
#: and 1.568e-2 logprob, its no-window control 1.07 and 2.01; Gemma's
#: kernels 1.19e-2 and 1.95e-3, its segment control 1.49 and 0.272.  The
#: limit is 3.2x above Mistral's sound reading and 5.4x below the nearer
#: control's
TOL_FAMILY_LOGPROB = 5e-2
#: the packed SFT run's first loss (a token mean over the same batch in
#: rows of 16384) against the run in rows of the longest sequence: the
#: same sums in other layouts
TOL_SFT_PACKED_REL = 1e-4
#: DPO's first loss against ln 2: actor and reference hold the same
#: float32 weights (the model worker builds every model in float32; no
#: bf16 serving copy), but the reference's logprobs come from one
#: inference pass whose rows pack the sequences otherwise than the train
#: micro-batches do, so the bf16 products round otherwise: a pair's
#: logratio moves by ~1e-2 over ~7000 tokens, beta 0.1 scales it, and
#: the loss moves by a quarter of that (2.8e-04 measured)
TOL_DPO_LN2 = 2e-3
#: a remat policy's gradient norm against none's: the same arithmetic,
#: up to the order of the embedding gradient's atomic adds
TOL_REMAT_GNORM_REL = 1e-4
#: the second step's parameter change with bf16 mu or nu against float32
#: Adam's (relative L2): the stored moment rounds to 2^-9 relative, and
#: optax forms b1 mu with b1 rounded to bf16
TOL_MOMENT_DELTA = 2e-2
#: the factored second moment's change against Adam's: the same signs,
#: other magnitudes (the rank-1 estimate of g^2)
MIN_FACTORED_COS = 0.5
#: the flash phase's heads: (Hq, Hkv, head_dim, sliding window) of
#: Qwen2.5-1.5B, Gemma-2B and Mistral-7B-v0.1 (window 4096)
QWEN_HEADS = (12, 2, 128, None)
GEMMA_HEADS = (8, 1, 256, None)
MISTRAL_HEADS = (32, 8, 128, 4096)
#: the flash phase's layouts: (name, B, T, segment lengths per row,
#: heads).  The timed ones (FLASH_TIMED) go into the kernels line; the
#: others cover T below one 64-token tile, T not a multiple of a tile,
#: segments of one token, rows that end in padding and, windowed, a window
#: narrower than a tile and one that ends inside a tile, across segments
FLASH_LAYOUTS = (
    ("packed", 2, 4096, ((1000, 2000, 1096), (3128,)), QWEN_HEADS),
    ("long", 1, 16384, ((16384,),), QWEN_HEADS),
    ("ragged", 2, 200, ((50, 100), (33,)), QWEN_HEADS),
    ("short", 1, 32, ((32,),), QWEN_HEADS),
    ("odd", 2, 257, ((257,), (120, 1, 64)), QWEN_HEADS),
    ("mid", 2, 1000, ((999,), (1, 500, 300)), QWEN_HEADS),
    ("hd256_packed", 2, 4096, ((1000, 2000, 1096), (3128,)), GEMMA_HEADS),
    ("hd256_long", 1, 8192, ((8192,),), GEMMA_HEADS),
    ("hd256_odd", 2, 257, ((257,), (120, 1, 64)), (8, 1, 256, 70)),
    ("window_long", 1, 16384, ((16384,),), MISTRAL_HEADS),
    ("window_odd", 2, 333, ((333,), (120, 1, 100, 90)), (32, 8, 128, 37)),
)
#: layouts whose times go into the kernels line
FLASH_TIMED = ("packed", "long", "hd256_packed", "hd256_long", "window_long")

#: the async-PPO recipe's actor settings (training/configs/async_ppo.yaml)
PPO_RECIPE = dict(
    n_minibatches=4, kl_ctl=0.0, disable_value=True, use_decoupled_loss=True,
    behav_imp_weight_cap=5.0,
)
#: the recipe has 32768; with 2048, three of the four minibatches of the
#: 12822-token rollout accumulate over two micro-batches each (at 4096 every
#: minibatch fits in one)
MAX_TOKENS_PER_MB = 2048
#: the recipe's lr is 1e-6 with a warm-up that gives lr 0 on the first
#: step; 1e-4 without warm-up moves the bf16-cast weights in three steps
TRAIN_LR = 1e-4
TRAIN_STEPS = 3


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, device) -> float:
    """Mean device milliseconds per call of ``fn``: ``kernel_ab.time_ms``
    (CUDA events around calls enqueued behind a sleep kernel)."""
    from areal_tpu_torch.tools import kernel_ab

    return kernel_ab.time_ms(fn, iters, device)


# ---------------------------------------------------------------------------
# kernel vs plain version
# ---------------------------------------------------------------------------


def paged_inputs(B, Q, Hq, Hkv, hd, BS, MB, lengths, device, dtype,
                 n_layers, seed, int8=False):
    """q [B,Q,Hq,hd], pools [n_layers, NB, Hkv, BS, hd] (NB = B*MB) with a
    scrambled table [B, MB] and the given lengths: (q, k_pool, v_pool,
    k_scale, v_scale, tables, lengths).  With ``int8`` the random pools
    are quantized as the engine stores them, with their scale pools
    [n_layers, NB, Hkv, BS]; otherwise the scales are None."""
    import torch

    from areal_tpu_torch.models.paged import quantize_kv

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    NB = B * MB
    q = torch.randn((B, Q, Hq, hd), generator=g, device=device).to(dtype)
    pools = []
    for _ in range(2):
        pool = torch.empty((n_layers, NB, Hkv, BS, hd), dtype=dtype,
                           device=device)
        for layer in pool:  # one layer at a time: bounded f32 temporaries
            layer.copy_(torch.randn(layer.shape, generator=g, device=device))
        pools.append(pool)
    scales = [None, None]
    if int8:
        for i, pool in enumerate(pools):
            qp = torch.empty(pool.shape, dtype=torch.int8, device=device)
            sc = torch.empty(pool.shape[:-1], dtype=torch.float32,
                             device=device)
            for layer in range(n_layers):
                qp[layer], sc[layer] = quantize_kv(pool[layer])
            pools[i], scales[i] = qp, sc
    perm = torch.randperm(NB, generator=g, device=device)
    tables = perm.reshape(B, MB).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    return (q, pools[0], pools[1], scales[0], scales[1], tables, lens)


def bound(q, lengths, Hkv, hd, pool_item=None, scale_item=0):
    """(bytes ms, operations ms) for one call: bytes that must move (q,
    the valid K/V prefix with its scales, tables and lengths read once;
    acc, m, l written once) over HBM rate, vs the attention arithmetic
    over the bf16 tensor-core rate.  ``pool_item`` is the pool's element
    size (q's by default); ``scale_item`` the bytes of one slot's scale
    (4 for an int8 pool)."""
    B, Q, Hq, _ = q.shape
    tot = int(lengths.clamp(min=0).sum())
    item = q.element_size()
    pool_item = pool_item or item
    nbytes = (
        q.numel() * item
        + tot * Hkv * 2 * (hd * pool_item + scale_item)
        + B * 4 * 2
        + B * Q * Hq * (hd + 2) * 4
    )
    flops = 4.0 * tot * Q * Hq * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return t_bytes, t_ops


def check_partials(what, got, ref, lens):
    """Kernel partials (acc, m, l) against the plain version's; raises past
    TOL_OUT / TOL_M / TOL_L_REL or when a length-0 row is not exactly
    acc = 0, l = 0, m = -1e30.  Returns the largest absolute error of
    acc/l and m."""
    import torch

    acc, m, l = got
    acc_r, m_r, l_r = ref
    valid = lens > 0
    out = acc[valid] / l[valid][..., None]
    out_r = acc_r[valid] / l_r[valid][..., None]
    err_out = float((out - out_r).abs().max())
    err_m = float((m[valid] - m_r[valid]).abs().max())
    err_l = float(((l - l_r).abs() / l_r.abs().clamp(min=1.0)).max())
    empty = ~valid
    empty_ok = bool(
        (acc[empty] == 0).all() and (l[empty] == 0).all()
        and (m[empty] == -1e30).all()
    )
    finite = bool(torch.isfinite(acc).all() and torch.isfinite(l).all())
    log(f"kernel {what}: max err acc/l={err_out:.3e} m={err_m:.3e} "
        f"l(rel)={err_l:.3e} empty-rows-exact={empty_ok}")
    if not (finite and empty_ok and err_out <= TOL_OUT and err_m <= TOL_M
            and err_l <= TOL_L_REL):
        raise AssertionError(
            f"{what} disagrees with its plain version: acc/l {err_out} (tol "
            f"{TOL_OUT}), m {err_m} (tol {TOL_M}), l {err_l} (tol "
            f"{TOL_L_REL}), empty rows exact {empty_ok}, finite {finite}"
        )
    return max(err_out, err_m)


def kernel_case(name, fn, inputs, device, *, time_lengths=None,
                timing_iters=20):
    """``fn`` (a paged kernel's wrapper) against the plain version on
    ``inputs`` from :func:`paged_inputs`, and again on the same inputs
    (bit-identical), then timed with its plain version at
    ``time_lengths`` (default: the compared lengths).  Timed launches
    cycle through the pool's layers: the callers give the decode shapes
    enough layers that the bytes read between two calls on one layer
    exceed twice the L2 (``kernel_ab.cold_layers``).  Returns the
    measurements."""
    import torch

    from areal_tpu_torch.ops import paged_attention as pa

    q, kp, vp, ks, vs, tables, lens = inputs
    n_layers = kp.shape[0]
    B, Q, Hq, hd = q.shape
    _, NB, Hkv, BS, _ = kp.shape

    def call(f, i, lengths):
        sc = () if ks is None else (ks[i], vs[i])
        return f(q, kp[i], vp[i], tables, lengths, *sc)

    got = call(fn, 0, lens)
    again = call(fn, 0, lens)
    ref = call(pa.reference_paged_partials, 0, lens)
    _sync(device)
    pool = "int8" if ks is not None else str(kp.dtype).removeprefix("torch.")
    err = check_partials(
        f"{name}: B={B} Q={Q} Hq={Hq} Hkv={Hkv} hd={hd} BS={BS} "
        f"MB={tables.shape[1]} {pool} pool, lengths={lens.tolist()}",
        got, ref, lens)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name}: a repeated call differs")
    log(f"kernel {name}: repeated call bit-identical, {n_layers} pool layers "
        f"timed in turn")
    if fn is pa.paged_flash_attention_deep:
        log(f"kernel {name}: {deep_route(q, kp, ks)}")
    tl = lens if time_lengths is None else time_lengths
    layer = [0]

    def timed(f):
        def run():
            i = layer[0] = (layer[0] + 1) % n_layers
            call(f, i, tl)
        return run

    ms = time_ms(timed(fn), timing_iters, device)
    plain_ms = time_ms(timed(pa.reference_paged_partials),
                       max(2, timing_iters // 10), device)
    t_bytes, t_ops = bound(q, tl, Hkv, hd, kp.element_size(),
                           4 if ks is not None else 0)
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"kernel {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.5f} ms by {bound_by} (bytes / 3.35 TB/s: {t_bytes:.5f} "
        f"ms; operations / 989 TFLOP/s: {t_ops:.5f} ms) at lengths "
        f"{tl.tolist()}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                shape=f"B={B} Q={Q} Hq={Hq} Hkv={Hkv} hd={hd} {pool} pool, "
                      f"{int(tl.sum())} cached tokens")


def deep_route(q, k_pool, k_scale=None):
    """Which body of the deep kernel a call on these tensors runs, and its
    copy route (``deep_body``, ``deep_copy_route``: dtypes and shapes
    only), as a phrase for the log."""
    from areal_tpu_torch.ops import paged_attention as pa

    body = pa.deep_body(q.dtype, k_pool.dtype)
    if body == "cuda_cores":
        return "deep kernel body cuda_cores"
    BS, hd = k_pool.shape[-2:]
    route = pa.deep_copy_route(
        BS, hd, k_pool.dtype, None if k_scale is None else k_scale[0])
    return f"deep kernel body tensor_cores, {route} copies"


def compare_kernel(name, B, Q, lengths, device, *, fn=None, int8=False,
                   Hq=12, Hkv=2, hd=128, BS=PAGE_SIZE,
                   MB=KV_CACHE_LEN // PAGE_SIZE, n_layers=4, timing_iters=20):
    """A paged kernel (``fn``, default the standard one) against its plain
    version on one shape of a bf16 (or, with ``int8``, int8) pool, then
    timed; returns the measurements."""
    import torch

    from areal_tpu_torch.ops import paged_attention as pa

    inputs = paged_inputs(B, Q, Hq, Hkv, hd, BS, MB, lengths, device,
                          torch.bfloat16, n_layers, SEED, int8=int8)
    return kernel_case(name, fn or pa.paged_flash_attention, inputs, device,
                       timing_iters=timing_iters)


def kernel_phase(device, *, BS=PAGE_SIZE, MB=KV_CACHE_LEN // PAGE_SIZE,
                 Q_prefill=PREFILL_CHUNK, long_prefix=LONG_PREFILL_PREFIX,
                 long_MB=LONG_KV_CACHE_LEN // PAGE_SIZE, timing_iters=20,
                 mid_page=MID_PAGE_PREFIXES, verify=VERIFY_PREFIXES,
                 **shape):
    """The standard paged kernel at decode (Q=1, B=8) and prefill-chunk
    (Q=prefill chunk, its tensor-core entry) shapes, with lengths 0, 1,
    BS-1, BS, BS+1, a full table and two in between, at one prefill chunk
    after a ``long_prefix``-token prefix, at prefill chunks after the
    prefixes of ``mid_page`` (ending inside a page, as a prefix-cache hit
    leaves them), and at a speculative verify window's shape (a row a
    prefix of ``verify``, Q = ``SPEC_MAX_DRAFT`` + 1: the pending token
    and the drafts, each query over the whole prefix, as
    ``paged_window_forward`` reads it; a length-0 row is one that sits the
    window out), which bf16 q sends to the tensor-core entry too; bf16
    pools, then the int8 branch; then the deep kernel (bf16 and int8
    pools) at the prefill-chunk and decode shapes.  The decode shape is
    timed L2-cold."""
    from areal_tpu_torch.ops import paged_attention as pa
    from areal_tpu_torch.tools.kernel_ab import cold_layers, touched_bytes

    lengths = [0, 1, BS - 1, BS, BS + 1, MB * BS, (MB * BS) // 3,
               (MB * BS * 3) // 4]
    kw = dict(BS=BS, MB=MB, timing_iters=timing_iters, **shape)
    long_kw = dict(kw, MB=long_MB)
    # decode is timed L2-cold: one call reads ~10 MB (bf16), which the L2
    # holds, so it cycles over enough layers of pool
    cold = {int8: dict(kw, n_layers=cold_layers(touched_bytes(
        lengths, shape.get("Hkv", 2), shape.get("hd", 128), 1 if int8 else 2,
        4 if int8 else 0))) for int8 in (False, True)}
    out = {}
    for int8 in (False, True):
        tag = "int8 " if int8 else ""
        key = tag.replace(" ", "_")
        out[f"{key}decode"] = compare_kernel(
            f"{tag}decode", len(lengths), 1, lengths, device, int8=int8,
            **cold[int8])
        # the prefill calls must run the tensor-core entry
        pa.paged_flash_attention.prefill_launches = 0
        out[f"{key}prefill"] = compare_kernel(
            f"{tag}prefill", len(lengths), Q_prefill, lengths, device,
            int8=int8, **kw)
        out[f"{key}prefill_long"] = compare_kernel(
            f"{tag}prefill after {long_prefix} tokens", 1, Q_prefill,
            [long_prefix], device, int8=int8, **long_kw)
        out[f"{key}prefill_mid_page"] = compare_kernel(
            f"{tag}prefill after prefixes ending mid-page", len(mid_page),
            Q_prefill, list(mid_page), device, int8=int8, **kw)
        if pa.paged_flash_attention.prefill_launches == 0:
            raise AssertionError(f"{tag}prefill calls did not run the "
                                 "tensor-core prefill entry")
        pa.paged_flash_attention.prefill_launches = 0
        out[f"{key}verify"] = compare_kernel(
            f"{tag}verify window", len(verify), SPEC_MAX_DRAFT + 1,
            list(verify), device, int8=int8, **kw)
        if pa.paged_flash_attention.prefill_launches == 0:
            raise AssertionError(f"{tag}verify-window calls did not run the "
                                 "tensor-core prefill entry")
    for int8 in (False, True):
        tag = "_int8" if int8 else ""
        out[f"deep{tag}_prefill"] = compare_kernel(
            f"deep{' int8' if int8 else ''} prefill", len(lengths), Q_prefill,
            lengths, device, fn=pa.paged_flash_attention_deep, int8=int8,
            **kw)
        out[f"deep{tag}_decode"] = compare_kernel(
            f"deep{' int8' if int8 else ''} decode", len(lengths), 1, lengths,
            device, fn=pa.paged_flash_attention_deep, int8=int8,
            **cold[int8])
        std = out[f"{'int8_' if int8 else ''}decode"]["ms"]
        deep = out[f"deep{tag}_decode"]["ms"]
        log(f"dispatch timing {'int8' if int8 else 'bf16'} pool, the "
            f"{len(lengths)}-row decode shape (lengths {lengths}): standard "
            f"{std:.4f} ms, deep {deep:.4f} ms (deep/standard "
            f"{deep / std:.3f})")
    return out


def decode_dtype_checks(device, *, BS=PAGE_SIZE, MB=KV_CACHE_LEN // PAGE_SIZE,
                        Hq=12, Hkv=2, hd=128):
    """The decode entry and the deep kernel (its CUDA-core body) on the
    q/pool types off the main path (float32 and float16, one query token
    per row, and float32 with four, which takes tiles of 8 grouped rows)
    against the plain version, with a repeated call bit-identical."""
    import torch

    from areal_tpu_torch.ops import paged_attention as pa

    lengths = [0, 1, BS - 1, BS, BS + 1, MB * BS, (MB * BS) // 3,
               (MB * BS * 3) // 4]
    for dtype, Q in ((torch.float32, 1), (torch.float16, 1),
                     (torch.float32, 4)):
        q, kp, vp, _, _, tables, lens = paged_inputs(
            len(lengths), Q, Hq, Hkv, hd, BS, MB, lengths, device, dtype, 1,
            SEED + 5)
        if pa.paged_entry(Q, dtype, dtype) != pa.DECODE_ENTRY:
            raise AssertionError(f"{dtype} Q={Q} left the decode entry")
        if pa.deep_body(dtype, dtype) != "cuda_cores":
            raise AssertionError(f"{dtype} left the deep CUDA-core body")
        ref = pa.reference_paged_partials(q, kp[0], vp[0], tables, lens)
        for what, fn in (("decode entry", pa.paged_flash_attention),
                         ("deep kernel", pa.paged_flash_attention_deep)):
            got = fn(q, kp[0], vp[0], tables, lens)
            again = fn(q, kp[0], vp[0], tables, lens)
            _sync(device)
            check_partials(f"{what}, {dtype} q and pool, Q={Q}", got, ref,
                           lens)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{what} {dtype} Q={Q}: a repeated "
                                     "call differs")
        log(f"kernel deep kernel, {dtype} q and pool: "
            f"{deep_route(q, kp)}")


def long_kernel_phase(device, *, B=16, MB=None, BS=PAGE_SIZE,
                      contexts=None, timing_iters=20, n_layers=4):
    """The long-context serving shapes: the standard and deep kernels at
    decode (B rows, Q=1) over contexts up to ``MB * BS`` tokens, bf16 and
    int8 pools, each compared with the plain version at lengths 0, 1,
    BS-1, BS, BS+1, full and mixed, then timed on B full rows at every
    context of ``contexts``; the threshold those times support, as
    ``derive_dispatch_table`` reads them; and ``flash_decode`` over a
    contiguous cache of the full length, compared at mixed lengths and
    timed on full rows."""
    import torch

    from areal_tpu_torch.engine.dispatch import (
        DISPATCH_NEVER,
        derive_dispatch_table,
    )
    from areal_tpu_torch.ops import paged_attention as pa

    MB = MB or LONG_KV_CACHE_LEN // BS
    S = MB * BS
    contexts = contexts or DISPATCH_CONTEXTS
    lengths = ([0, 1, BS - 1, BS, BS + 1, S, S - 1, S // 2 + 3]
               + [S * (i + 1) // (B - 8) for i in range(B - 8)])
    assert len(lengths) == B
    full = torch.full((B,), S, dtype=torch.int32, device=device)
    out = {}
    for int8 in (False, True):
        tag = "int8" if int8 else "bf16"
        inputs = paged_inputs(B, 1, 12, 2, 128, BS, MB, lengths, device,
                              torch.bfloat16, n_layers, SEED + 7, int8=int8)
        for name, fn in (("standard", pa.paged_flash_attention),
                         ("deep", pa.paged_flash_attention_deep)):
            out[f"{name}_{tag}"] = kernel_case(
                f"{name} decode {tag}", fn, inputs, device, time_lengths=full,
                timing_iters=timing_iters)
        q, kp, vp, ks, vs, tables, _ = inputs
        rows = {}
        for ctx in contexts:
            mb = -(-ctx // BS)
            tab = tables[:, :mb].contiguous()
            lens = torch.full((B,), ctx, dtype=torch.int32, device=device)
            times = {}
            for name, fn in (("paged", pa.paged_flash_attention),
                             ("deep", pa.paged_flash_attention_deep)):
                layer = [0]

                def run(fn=fn):
                    i = layer[0] = (layer[0] + 1) % n_layers
                    sc = () if ks is None else (ks[i], vs[i])
                    fn(q, kp[i], vp[i], tab, lens, *sc)

                times[name] = time_ms(run, timing_iters, device)
            t_bytes, _ = bound(q, lens, 2, 128, kp.element_size(),
                               4 if int8 else 0)
            log(f"dispatch timing {tag} pool, {B} rows x {ctx} tokens: "
                f"standard {times['paged']:.4f} ms, deep {times['deep']:.4f} "
                f"ms (deep/standard {times['deep'] / times['paged']:.3f}); "
                f"bound {t_bytes:.5f} ms (bytes)")
            rows[ctx] = {"dense": None, "paged": 1.0 / times["paged"],
                         "deep": 1.0 / times["deep"]}
        table = derive_dispatch_table(rows)
        thr = table.deep_min_context
        log(f"dispatch timing {tag} pool: the times support deep_min_context="
            f"{'never' if thr == DISPATCH_NEVER else thr} "
            f"(derive_dispatch_table over calls per ms)")
        del inputs, q, kp, vp, ks, vs, tables
        torch.cuda.empty_cache()
    out["flash_decode"] = flash_decode_case(
        device, B=B, S=S, lengths=lengths, timing_iters=timing_iters,
        n_layers=n_layers)
    return out


def flash_decode_case(device, *, B, S, lengths, timing_iters, n_layers,
                      Hq=12, Hkv=2, hd=128):
    """``flash_decode`` against its plain version over a contiguous bf16
    cache [B, Hkv, S, hd] at ``lengths``, then timed on full rows beside
    ``scaled_dot_product_attention`` of the same query over the same rows
    (a normalised output in place of the partials; the yardstick only)."""
    import torch

    from areal_tpu_torch.ops import decode_attention as da

    g = torch.Generator(device=device)
    g.manual_seed(SEED + 9)
    q = torch.randn((B, Hq, hd), generator=g, device=device).to(torch.bfloat16)
    caches = []
    for _ in range(2):
        c = torch.empty((n_layers, B, Hkv, S, hd), dtype=torch.bfloat16,
                        device=device)
        for layer in c:
            layer.copy_(torch.randn(layer.shape, generator=g, device=device))
        caches.append(c)
    k, v = caches
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    got = da.flash_decode(q, k[0], v[0], lens)
    again = da.flash_decode(q, k[0], v[0], lens)
    ref = da.reference_decode_partials(q, k[0], v[0], lens)
    _sync(device)
    err = check_partials(
        f"flash_decode: B={B} Hq={Hq} Hkv={Hkv} hd={hd} S={S} bf16 cache, "
        f"lengths={lengths}", got, ref, lens)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"flash_decode at B={B} S={S}: a repeated call "
                             "is not bit-identical")
    full = torch.full((B,), S, dtype=torch.int32, device=device)
    layer = [0]

    def timed(f):
        def run():
            i = layer[0] = (layer[0] + 1) % n_layers
            f(q, k[i], v[i], full)
        return run

    ms = time_ms(timed(da.flash_decode), timing_iters, device)
    plain_ms = time_ms(timed(da.reference_decode_partials),
                       max(2, timing_iters // 10), device)
    qs = q[:, :, None]  # [B, Hq, 1, hd]

    def sdpa(q_, k_, v_, _):
        return torch.nn.functional.scaled_dot_product_attention(
            qs, k_, v_, enable_gqa=True)

    library_ms = time_ms(timed(sdpa), timing_iters, device)
    log(f"kernel flash_decode: SDPA's device kernels for one call: "
        f"{sdpa_kernels(lambda: sdpa(q, k[0], v[0], full), device)}")
    t_bytes, t_ops = bound(q[:, None], full, Hkv, hd)
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"kernel flash_decode: {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
        f"{library_ms:.4f} ms, bound {bound_ms:.5f} ms by {bound_by} ({B} "
        f"full rows of {S} tokens); "
        f"{deep_route(q, k[0])} (the cache is a pool of {B} pages of {S})")
    del caches, k, v
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms,
                shape=f"B={B} Hq={Hq} Hkv={Hkv} hd={hd} S={S} bf16 cache, "
                      f"{B * S} cached tokens")


def sdpa_kernels(fn, device) -> str:
    """The device kernels one call of ``fn`` launches (``torch.profiler``
    device rows; the backend SDPA chose shows in their names)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return "not measured (no card)"
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if getattr(e, "device_time_total", 0) > 0})
    return ", ".join(names) if names else "not measured (no device rows)"


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def make_prompts(vocab: int, lens, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lens]


def requests(prompts, max_new, tag):
    from areal_tpu_torch.api.model_api import (
        APIGenerateInput,
        GenerationHyperparameters,
    )

    return [
        APIGenerateInput(
            qid=f"{tag}-{i}", prompt_ids=p, input_ids=p,
            gconfig=GenerationHyperparameters(max_new_tokens=max_new),
        )
        for i, p in enumerate(prompts)
    ]


def serve(eng, reqs, max_steps=100000):
    """Submit ``reqs`` and step the engine until it drains; returns (results
    in request order, wall seconds)."""
    import torch

    tik = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    for _ in range(max_steps):
        if not eng.has_work:
            break
        eng.step()
    else:
        raise AssertionError("engine did not drain")
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - tik
    res = eng.drain_results()
    out = [res.pop(r.qid) for r in reqs]
    if res:
        raise AssertionError(f"unexpected results {sorted(res)}")
    return out, secs


def check_outputs(outs, cfg, max_new, what):
    for o in outs:
        n = len(o.output_ids)
        if not (1 <= n <= max_new) or len(o.output_logprobs) != n:
            raise AssertionError(f"{what} {o.qid}: {n} tokens / "
                                 f"{len(o.output_logprobs)} logprobs")
        if not all(0 <= t < cfg.vocab_size for t in o.output_ids):
            raise AssertionError(f"{what} {o.qid}: token out of vocabulary")
        if not all(math.isfinite(x) and x <= 0 for x in o.output_logprobs):
            raise AssertionError(f"{what} {o.qid}: bad logprob")


def build_engine(cfg, params, device, sampling, **kw):
    from areal_tpu_torch.engine.inference_server import (
        ContinuousBatchingEngine,
    )

    # the prefix cache and the SLO records are off unless asked for: the
    # earlier phases resubmit their prompts, and their work counts and
    # times stay comparable with those of an engine without either (the
    # generation server's engine has both, as its config's defaults say)
    settings = dict(
        max_batch=MAX_BATCH, kv_cache_len=KV_CACHE_LEN,
        chunk_size=CHUNK_SIZE, cache_mode="paged", page_size=PAGE_SIZE,
        prefill_chunk_tokens=PREFILL_CHUNK, pipeline_depth=PIPELINE_DEPTH,
        seed=SEED, prefix_cache=False, slo_tracking=False,
    )
    settings.update(kw)
    return ContinuousBatchingEngine(
        cfg, params, sampling=sampling, device=device, **settings
    )


def audit_pool(eng, what):
    """The engine's leak audit: ``close()`` accounts for every held pool
    block by refcount (rows, parked rows and the prefix cache); then, with
    the parked rows released and the cache flushed, the pool is whole."""
    import numpy as np

    leaked = eng.close()
    held = eng.n_blocks - eng.free_pool_blocks
    eng.park_ttl_steps = 0
    eng.step()  # releases the parked rows
    if eng._prefix_cache is not None:
        eng._prefix_cache.flush()
    after = eng.close()
    if (leaked or after or eng.n_parked
            or eng.free_pool_blocks != eng.n_blocks
            or (np.asarray(eng._block_ref) != 0).any()):
        raise AssertionError(
            f"{what}: leak audit {leaked} (then {after}), {eng.n_parked} "
            f"parked, free {eng.free_pool_blocks}/{eng.n_blocks}")
    log(f"{what}: the refcount audit accounts for the {held} held blocks; "
        f"with the parked rows released and the cache flushed the pool is "
        f"whole ({eng.n_blocks} blocks)")


def engine_phase(cfg, params, device, *, prompt_lens=PROMPT_LENS,
                 new_tokens=NEW_TOKENS, card="", **engine_kw):
    """The main path: a greedy wave of ``new_tokens`` per request, with the
    kernel's launch count set to 0 just before it and read just after."""
    from areal_tpu_torch.engine.sampling import SamplingParams
    from areal_tpu_torch.ops.paged_attention import paged_flash_attention

    eng = build_engine(cfg, params, device, SamplingParams(greedy=True),
                       **engine_kw)
    prompts = make_prompts(cfg.vocab_size, prompt_lens, SEED)
    # warm-up (library handles, allocator), not timed
    serve(eng, requests([p[:64] for p in prompts[:2]], 4, "warm"))
    # prefill throughput: a wave that stops after each request's first token
    p0 = eng.prefill_tokens_total
    _, prefill_secs = serve(eng, requests(prompts, 1, "prefill"))
    prefill_tps = (eng.prefill_tokens_total - p0) / prefill_secs

    # the main path
    f0, d0 = eng.prefill_calls, eng.decode_chunks_total
    t0 = eng.decode_tokens_total
    paged_flash_attention.launches = 0
    paged_flash_attention.prefill_launches = 0
    outs, secs = serve(eng, requests(prompts, new_tokens, "greedy"))
    launches = paged_flash_attention.launches
    prefill_launches = paged_flash_attention.prefill_launches
    fills, chunks = eng.prefill_calls - f0, eng.decode_chunks_total - d0
    expected = cfg.n_layers * (fills + chunks * eng.chunk_size)
    check_outputs(outs, cfg, new_tokens, "greedy")
    dec_tok = eng.decode_tokens_total - t0
    decode_tps = dec_tok / (secs - prefill_secs)
    log(f"engine greedy wave: {len(outs)} requests, prompts {list(prompt_lens)}, "
        f"{sum(len(o.output_ids) for o in outs)} new tokens in {secs:.2f} s; "
        f"{fills} fill chunks + {chunks} decode chunks of {eng.chunk_size} "
        f"steps x {cfg.n_layers} layers = {expected} kernel launches "
        f"expected, {launches} counted, {prefill_launches} of them on the "
        f"prefill entry (expected {cfg.n_layers * fills})")
    if (launches != expected or launches == 0
            or prefill_launches != cfg.n_layers * fills):
        raise AssertionError(
            f"paged_flash_attention launched {launches} times on the main "
            f"path ({prefill_launches} prefill-entry); the engine dispatched "
            f"work for {expected} ({cfg.n_layers * fills} fill-chunk calls)"
        )
    log(f"engine throughput on {card}: prefill {prefill_tps:.1f} tok/s (prompt tokens "
        f"of a first-token-only wave / its wall time {prefill_secs:.2f} s); "
        f"decode {decode_tps:.1f} tok/s ({dec_tok} decode-chunk tokens / "
        f"the greedy wave's wall time less the first-token wave's)")

    # resubmitting the same greedy wave, cut to its first RESUBMIT_TOKENS
    # tokens, gives the same streams' heads (the rows fill and decode
    # together as in the first wave, over pool blocks it left behind)
    again, _ = serve(eng, requests(prompts, RESUBMIT_TOKENS, "greedy"))
    if ([o.output_ids for o in again]
            != [o.output_ids[:RESUBMIT_TOKENS] for o in outs]):
        raise AssertionError("a resubmitted greedy wave changed its tokens")
    log(f"engine check: resubmitted greedy wave gives identical tokens (its "
        f"first {RESUBMIT_TOKENS} of {new_tokens})")

    # update_weights changes the output and stamps the new version
    short = requests([p[:200] for p in prompts[:2]], 16, "swap")
    before, _ = serve(eng, short)
    perturbed = _perturbed(params, SEED + 3)
    eng.update_weights(perturbed, version=1)
    after, _ = serve(eng, short)
    if [o.output_ids for o in after] == [o.output_ids for o in before]:
        raise AssertionError("update_weights did not change the output")
    if any(o.version_start != 1 or o.version_end != 1 for o in after):
        raise AssertionError("update_weights did not stamp version 1")
    eng.update_weights(params, version=2)
    restored, _ = serve(eng, short)
    if [o.output_ids for o in restored] != [o.output_ids for o in before]:
        raise AssertionError("restoring the weights did not restore output")
    log("engine check: update_weights changes the output, stamps the "
        "version, and restoring the weights restores it")
    audit_pool(eng, "engine check")
    return dict(launches=launches, prefill_launches=prefill_launches,
                prefill_tps=prefill_tps, decode_tps=decode_tps, outs=outs)


def sampled_phase(cfg, params, device, *, prompt_lens=PROMPT_LENS,
                  new_tokens=SAMPLED_NEW_TOKENS, **engine_kw):
    """A second wave sampled at temperature 1, twice, at two pipeline
    depths: the position-keyed streams must agree."""
    from areal_tpu_torch.engine.sampling import SamplingParams

    prompts = make_prompts(cfg.vocab_size, prompt_lens, SEED + 1)
    streams = []
    for depth in (PIPELINE_DEPTH, 1):
        kw = dict(engine_kw, pipeline_depth=depth)
        eng = build_engine(cfg, params, device,
                           SamplingParams(temperature=1.0), **kw)
        outs, secs = serve(eng, requests(prompts, new_tokens, "sampled"))
        check_outputs(outs, cfg, new_tokens, "sampled")
        if eng.close():
            raise AssertionError("sampled engine leaked pool blocks")
        streams.append([o.output_ids for o in outs])
        log(f"engine sampled wave (temperature 1, pipeline depth {depth}): "
            f"{sum(len(s) for s in streams[-1])} tokens in {secs:.2f} s")
    if streams[0] != streams[1]:
        raise AssertionError("sampled streams differ across pipeline depths")
    log("engine check: sampled streams identical across pipeline depths")


def chunked_prefill_phase(cfg, params, device, *, prompt_len=1500,
                          chunk=PREFILL_CHUNK, BS=PAGE_SIZE):
    """The same prompt's final logits with chunked prefill (later chunks
    read the cached pages through the kernel) and one-chunk prefill (which
    reads none)."""
    import torch

    from areal_tpu_torch.models import paged

    prompt = make_prompts(cfg.vocab_size, [prompt_len], SEED + 2)[0]
    MB = -(-prompt_len // BS)
    tables = torch.arange(MB, dtype=torch.int32, device=device)[None]
    i32 = dict(dtype=torch.int32, device=device)

    def prefill(chunk_len):
        kp, vp, _, _ = paged.alloc_kv_pool(cfg, MB, BS, device)
        for s in range(0, prompt_len, chunk_len):
            n = min(chunk_len, prompt_len - s)
            logits = paged.paged_fill_chunk(
                params, kp, vp, cfg,
                torch.tensor([prompt[s:s + n]], **i32),
                torch.tensor([s], **i32), torch.tensor([n], **i32), tables,
            )
        return logits[0].float()

    a, b = prefill(chunk), prefill(prompt_len)
    rel = float((a - b).norm() / b.norm())
    same_top = bool(a.argmax() == b.argmax())
    log(f"engine check: chunked ({chunk}) vs one-chunk prefill of "
        f"{prompt_len} tokens: relative L2 logit difference {rel:.3e} "
        f"(tolerance {TOL_CHUNKED_LOGITS}), same argmax {same_top}")
    if not (math.isfinite(rel) and rel <= TOL_CHUNKED_LOGITS):
        raise AssertionError("chunked and one-chunk prefill disagree")


def device_seconds(prof, names):
    """(device busy seconds, seconds in kernels whose name contains one of
    ``names``) of a ``torch.profiler`` run.  Only device-side rows
    (kernels, copies) count, as torch's own table sums them: a CPU op's row
    repeats the time of the kernels it launched, so summing every row would
    count most device time twice."""
    from torch.autograd import DeviceType

    busy = part = 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or getattr(
            ev, "is_user_annotation", False
        ):
            continue
        us = ev.self_device_time_total
        busy += us
        if any(n in ev.key for n in names):
            part += us
    return busy / 1e6, part / 1e6


def top_device_rows(prof, n):
    """The ``n`` device-side rows of a ``torch.profiler`` run with the most
    time: [(seconds, calls, name cut to 60 characters)]."""
    from torch.autograd import DeviceType

    rows = [
        (ev.self_device_time_total / 1e6, ev.count, ev.key[:60])
        for ev in prof.key_averages()
        if ev.device_type == DeviceType.CUDA
        and not getattr(ev, "is_user_annotation", False)
    ]
    return sorted(rows, reverse=True)[:n]


def anatomy(fn, label, top=0):
    """Host enqueue time, wall time and device busy time of one call of
    ``fn`` (warmed up), and the paged kernel's share of the device time
    (both of its entries and the split merge).  Device time is the sum of
    the kernels' and copies' own time in a ``torch.profiler`` trace of a
    second call; idle share is one minus device time over the unprofiled
    wall time.  With ``top``, also the ``top`` device rows with the most
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    tik = time.perf_counter()
    fn()
    enqueue = time.perf_counter() - tik
    torch.cuda.synchronize()
    wall = time.perf_counter() - tik
    # device activity only, as in _device_profile: the rows read below
    # are device rows, and host ops need not be traced for them
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    busy, kern = device_seconds(
        prof, ("paged_decode_kernel", "paged_prefill_kernel",
               "combine_splits_kernel"))
    if busy > 0:
        dev = (f"device busy {busy * 1e3:.2f} ms (idle share "
               f"{1 - busy / wall:.3f}), paged kernel "
               f"{kern * 1e3:.2f} ms = {kern / busy:.3f} of device time")
    else:
        dev = "device time not measured (the profiler saw no device events)"
    log(f"anatomy {label}: host enqueue {enqueue * 1e3:.2f} ms, wall "
        f"{wall * 1e3:.2f} ms; {dev}")
    for sec, calls, name in top_device_rows(prof, top):
        log(f"anatomy {label} device time: {sec * 1e3:.3f} ms in {calls} "
            f"calls of {name}")
    return wall


def anatomy_phase(cfg, params, device, *, lens=PROMPT_LENS,
                  long_prefix=LONG_PREFILL_PREFIX):
    """Where a decode chunk's and a prefill chunk's time goes, outside the
    engine: one decode chunk (8 rows at the prompt lengths, all active,
    ``CHUNK_SIZE`` steps) and one prefill chunk (one row,
    ``PREFILL_CHUNK`` tokens after a 2560-token cached prefix, and after a
    ``long_prefix``-token prefix read through a table over the whole
    pool), over a pool of random KV."""
    import torch

    from areal_tpu_torch.engine.sampling import (
        SamplingParams,
        sample_logits_keyed,
    )
    from areal_tpu_torch.models import paged

    B, MB = len(lens), KV_CACHE_LEN // PAGE_SIZE
    kp, vp, _, _ = paged.alloc_kv_pool(cfg, B * MB, PAGE_SIZE, device)
    kp.normal_()
    vp.normal_()
    i32 = dict(dtype=torch.int32, device=device)
    tables = torch.arange(B * MB, **i32).reshape(B, MB)
    lengths = torch.tensor(lens, **i32)
    greedy = SamplingParams(greedy=True)

    def decode():
        paged.paged_decode_chunk(
            params, kp, vp, cfg, tables, lengths, torch.zeros(B, **i32),
            torch.ones(B, dtype=torch.bool, device=device),
            torch.full((B,), 1 << 20, **i32), CHUNK_SIZE,
            lambda lg, pos, sd: sample_logits_keyed(lg, SEED, sd, pos, greedy),
            lambda tok: tok < 0, KV_CACHE_LEN, torch.arange(B, **i32),
        )

    toks = torch.randint(0, cfg.vocab_size, (1, PREFILL_CHUNK), **i32)

    def fill():
        paged.paged_fill_chunk(
            params, kp, vp, cfg, toks, torch.tensor([2560], **i32),
            torch.tensor([PREFILL_CHUNK], **i32), tables[:1],
        )

    wall = anatomy(decode, f"decode chunk ({B} rows x {CHUNK_SIZE} steps)")
    log(f"anatomy: decode at batch {B} runs {B * CHUNK_SIZE / wall:.1f} tok/s "
        f"({wall / CHUNK_SIZE * 1e3:.2f} ms per step)")
    wall = anatomy(fill, f"prefill chunk ({PREFILL_CHUNK} tokens)")
    log(f"anatomy: prefill chunk runs {PREFILL_CHUNK / wall:.1f} tok/s")

    def fill_long():
        paged.paged_fill_chunk(
            params, kp, vp, cfg, toks, torch.tensor([long_prefix], **i32),
            torch.tensor([PREFILL_CHUNK], **i32),
            torch.arange(B * MB, **i32)[None],
        )

    wall = anatomy(fill_long, f"prefill chunk ({PREFILL_CHUNK} tokens after "
                   f"{long_prefix})", top=8)
    log(f"anatomy: prefill chunk after {long_prefix} tokens runs "
        f"{PREFILL_CHUNK / wall:.1f} tok/s")


# ---------------------------------------------------------------------------
# flash attention: kernels vs plain version
# ---------------------------------------------------------------------------


def flash_inputs(B, T, rows, device, Hq, Hkv, hd, seed=SEED):
    """bf16 q [B,T,Hq,hd], k/v [B,T,Hkv,hd], dO like q, and int32 seg_ids
    [B,T] with the given segment lengths per row (the rest padding)."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=device).to(torch.bfloat16)

    seg = torch.zeros((B, T), dtype=torch.int32)
    for b, lens in enumerate(rows):
        c = 0
        for i, L in enumerate(lens):
            seg[b, c:c + L] = i + 1
            c += L
    return (rnd(B, T, Hq, hd), rnd(B, T, Hkv, hd), rnd(B, T, Hkv, hd),
            rnd(B, T, Hq, hd), seg.to(device))


def plain_flash(q, k, v, seg, dout=None, window=None):
    """The plain version, one query head at a time (at T = 16384 a whole
    [B, Hq, T, T] score tensor and its backward would not fit): (out, lse)
    and, with ``dout``, float32 (dq, dk, dv) by autograd."""
    import torch

    from areal_tpu_torch.ops.flash_attention import reference_flash_attention

    B, T, Hq, hd = q.shape
    r = Hq // k.shape[2]
    outs, lses = [], []
    grads = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
             for t in (q, k, v)] if dout is not None else None
    for h in range(Hq):
        g = h // r
        args = [t[:, :, i:i + 1].float() for t, i in ((q, h), (k, g), (v, g))]
        with torch.set_grad_enabled(dout is not None):
            if dout is not None:
                for a in args:
                    a.requires_grad_(True)
            out, lse = reference_flash_attention(*args, seg, return_lse=True,
                                                 window=window)
            if dout is not None:
                out.backward(dout[:, :, h:h + 1].float())
                grads[0][:, :, h] = args[0].grad[:, :, 0]
                grads[1][:, :, g] += args[1].grad[:, :, 0]
                grads[2][:, :, g] += args[2].grad[:, :, 0]
        outs.append(out.detach())
        lses.append(lse.detach())
    return torch.cat(outs, dim=2), torch.cat(lses, dim=1), grads


def attended_pairs(seg, window=None) -> int:
    """The (query, key) pairs the function attends at this data: in a
    segment of L tokens, query i sees min(i + 1, window) keys, so
    L (L + 1) / 2 without a window and W (W + 1) / 2 + (L - W) W past it."""
    import torch

    pairs = 0
    for b in range(seg.shape[0]):
        _, counts = torch.unique_consecutive(seg[b][seg[b] != 0],
                                             return_counts=True)
        for L in counts.tolist():
            W = L if window is None else min(L, window)
            pairs += W * (W + 1) // 2 + (L - W) * W
    return pairs


def flash_bound(q, k, seg, backward: bool, window=None):
    """(bytes ms, operations ms) of one forward or backward call at this
    data: the pairs it attends (:func:`attended_pairs`: causal, inside
    segments and inside the window) times 4 (forward: QK^T, PV) or 10
    (backward: QK^T recomputed, dO V^T, P^T dO, dS^T Q, dS K) flops per
    head-dim element per query head, over 989 TFLOP/s; and each input read
    once and each output written once, over 3.35 TB/s."""
    B, T, Hq, hd = q.shape
    pairs = attended_pairs(seg, window)
    item = q.element_size()
    qb, kb = q.numel() * item, k.numel() * item
    lse_b, seg_b = B * Hq * T * 4, seg.numel() * 4
    if backward:  # q, k, v, out, dout, lse, seg in; dq, dk, dv out
        nbytes = 3 * qb + 2 * kb + lse_b + seg_b + qb + 2 * kb
        flops = 10.0 * pairs * Hq * hd
    else:  # q, k, v, seg in; out, lse out
        nbytes = qb + 2 * kb + seg_b + qb + lse_b
        flops = 4.0 * pairs * Hq * hd
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3


def _rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _flash_out_errors(out, ref_out, real):
    """(relative L2 distance of out over real tokens, the largest one
    real token's)."""
    d_out = (out.float() - ref_out)[real]
    return (float(d_out.norm() / ref_out[real].norm()),
            float((d_out.flatten(1).norm(dim=1)
                   / ref_out[real].flatten(1).norm(dim=1)).max()))


def compare_flash(name, B, T, rows, heads, device, timing_iters=10,
                  timed=True):
    """Forward and backward kernels vs the plain version on one layout at
    ``heads`` = (Hq, Hkv, hd, window); returns {"fwd": {...}, "bwd":
    {...}} measurements (with ``timed`` false, the largest absolute errors
    alone).  A windowed layout also runs its control: the forward kernel
    without the window must fail the out gates against the windowed plain
    version."""
    import torch
    import torch.nn.functional as F

    from areal_tpu_torch.ops import flash_attention as fa

    Hq, Hkv, hd, window = heads
    q, k, v, dout, seg = flash_inputs(B, T, rows, device, Hq, Hkv, hd)
    real = seg != 0
    out, lse = fa.flash_attention_with_lse(q, k, v, seg, window)
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    fa.flash_attention(qs, ks, vs, seg, window).backward(dout)
    grads = [t.grad for t in (qs, ks, vs)]
    # the forward and backward again: bit-identical (no atomics)
    out2, lse2 = fa.flash_attention_with_lse(q, k, v, seg, window)
    qs2, ks2, vs2 = (t.clone().requires_grad_(True) for t in (q, k, v))
    fa.flash_attention(qs2, ks2, vs2, seg, window).backward(dout)
    repeat = (torch.equal(out, out2) and torch.equal(lse, lse2)
              and all(torch.equal(a, b.grad)
                      for a, b in zip(grads, (qs2, ks2, vs2))))
    ref_out, ref_lse, ref_grads = plain_flash(q, k, v, seg, dout, window)
    _sync(device)

    d_out = (out.float() - ref_out)[real]
    err_out, err_tok = _flash_out_errors(out, ref_out, real)
    abs_fwd = max(float(d_out.abs().max()),
                  float((lse - ref_lse).transpose(1, 2)[real].abs().max()))
    abs_bwd = max(float((a.float() - b).abs().max())
                  for a, b in zip(grads, ref_grads))
    err_lse = float((lse - ref_lse).transpose(1, 2)[real].abs().max())
    pad_ok = bool((out[~real] == 0).all()) and bool(
        torch.isposinf(lse.transpose(1, 2)[~real]).all())
    err_g = [_rel_l2(a, b) for a, b in zip(grads, ref_grads)]
    finite = all(bool(torch.isfinite(t).all()) for t in (out, *grads))
    shape = (f"B={B} T={T} Hq={Hq} Hkv={Hkv} hd={hd} window={window} bf16 "
             f"segments {[list(r) for r in rows]}")
    log(f"flash {name}: {shape}: out "
        f"rel L2 {err_out:.3e} (tol {TOL_FA_OUT}), worst token's rel L2 "
        f"{err_tok:.3e} (tol {TOL_FA_OUT_TOKEN}), lse {err_lse:.3e} "
        f"(tol {TOL_FA_LSE}), dq/dk/dv rel L2 "
        f"{' '.join(f'{e:.3e}' for e in err_g)} (tol {TOL_FA_GRAD}), padding "
        f"exact {pad_ok}, repeat forward and backward bit-identical {repeat}")
    if not (finite and pad_ok and repeat and err_out <= TOL_FA_OUT
            and err_tok <= TOL_FA_OUT_TOKEN and err_lse <= TOL_FA_LSE
            and max(err_g) <= TOL_FA_GRAD):
        raise AssertionError(f"flash_attention ({name}) disagrees with its "
                             "plain version")
    control = None
    if window is not None:
        # the control: the kernel without the window, against the windowed
        # plain version, must fail the out gates
        out_nw, _ = fa.flash_attention_with_lse(q, k, v, seg)
        control = _flash_out_errors(out_nw, ref_out, real)
        log(f"flash {name}: control, the kernel without the window: out rel "
            f"L2 {control[0]:.3e}, worst token's {control[1]:.3e}")
        if control[0] <= TOL_FA_OUT and control[1] <= TOL_FA_OUT_TOKEN:
            raise AssertionError(f"flash {name}: the no-window control "
                                 f"{control} passes the gates")
    if not timed:
        return {"fwd": dict(max_abs_err=abs_fwd, control=control),
                "bwd": dict(max_abs_err=abs_bwd)}

    # timings: kernels, plain version, and SDPA with the same mask (a
    # boolean [B, 1, T, T] mask, the window in it)
    mask = fa.attention_mask(seg, window)[:, None]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa(*a):
        return F.scaled_dot_product_attention(*a, attn_mask=mask,
                                              enable_gqa=True)

    def bwd_timer(fwd):
        """ms of the backward alone, replayed on a retained graph."""
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = fwd(*ins)
        g = dout if o.shape == dout.shape else dout.transpose(1, 2)
        return lambda: o.backward(g, retain_graph=True)

    res = {}
    ms_f = time_ms(lambda: fa.flash_attention_with_lse(q, k, v, seg, window),
                   timing_iters, device)
    ms_b = time_ms(bwd_timer(lambda *a: fa.flash_attention(*a, seg, window)),
                   timing_iters, device)
    # the backward's kernels one at a time, on the forward's outputs
    _, lse_k, ranges = fa._launch_fwd(q, k, v, seg, window)
    parts = {
        part: time_ms(lambda bit=bit: fa._launch_bwd(
            q, k, v, seg, ranges, out, lse_k, dout, window, parts=bit),
            timing_iters, device)
        for part, bit in fa.BWD_PARTS.items()
    }
    log(f"flash {name} bwd by kernel (ms per call): "
        + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
        + f"; sum {sum(parts.values()):.4f}")
    plain_f = time_ms(lambda: plain_flash(q, k, v, seg, window=window), 2,
                      device)
    plain_fb = time_ms(lambda: plain_flash(q, k, v, seg, dout, window), 2,
                       device)
    try:
        lib_f = time_ms(lambda: sdpa(qt, kt, vt), timing_iters, device)
        lib_b = time_ms(bwd_timer(lambda a, b, c: sdpa(
            a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2))),
            timing_iters, device)
        # the attention kernels only (the mask's fill and where kernels
        # run too), their names cut to 100 characters
        sdpa_backend = ", ".join(
            n[:100] for n in sdpa_kernels(lambda: sdpa(qt, kt, vt),
                                          device).split(", ")
            if any(w in n.lower() for w in ("sdpa", "fmha", "attention",
                                            "flash", "efficient", "not ")))
    except (torch.OutOfMemoryError, TypeError, RuntimeError) as e:
        # the yardstick only
        log(f"flash {name}: SDPA yardstick failed ({e}); library_ms null")
        lib_f = lib_b = None
        sdpa_backend = f"failed: {e}"
    log(f"flash {name}: SDPA (boolean mask) ran {sdpa_backend}")
    for kind, ms, plain_ms, lib_ms, err in (
        ("fwd", ms_f, plain_f, lib_f, abs_fwd),
        ("bwd", ms_b, max(plain_fb - plain_f, 0.0), lib_b, abs_bwd),
    ):
        t_bytes, t_ops = flash_bound(q, k, seg, kind == "bwd", window)
        bound_ms = max(t_bytes, t_ops)
        res[kind] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=lib_ms, shape=shape, sdpa_kernels=sdpa_backend,
            **({"parts_ms": parts} if kind == "bwd" else {}),
            **({"control": control} if kind == "fwd" else {}),
        )
        log(f"flash {name} {kind}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"SDPA {lib_ms if lib_ms is None else f'{lib_ms:.4f}'} ms, bound "
            f"{bound_ms:.5f} ms by {res[kind]['bound_by']} (bytes / 3.35 TB/s: "
            f"{t_bytes:.5f} ms; operations / 989 TFLOP/s: {t_ops:.5f} ms); "
            f"kernel at {bound_ms / ms:.3f} of its bound")
    log(f"flash {name}: plain backward ms = plain forward+backward "
        f"{plain_fb:.4f} ms less plain forward {plain_f:.4f} ms")
    return res


def flash_phase(device, layouts=FLASH_LAYOUTS, timing_iters=10):
    res = {}
    for name, B, T, rows, heads in layouts:
        tik = time.perf_counter()
        res[name] = compare_flash(name, B, T, rows, heads, device,
                                  timing_iters, timed=name in FLASH_TIMED)
        log(f"flash {name}: {time.perf_counter() - tik:.1f} s")
    return res


# ---------------------------------------------------------------------------
# the trainer: one async-PPO iteration
# ---------------------------------------------------------------------------


def rollout_sample(outs, seed):
    """The greedy wave's output as the trainer's rollout: prompt + output
    tokens, the prompt mask, the engine's logprobs as behaviour logprobs
    (0 on prompt transitions), a reward per sequence drawn from ``seed``,
    and the no-EOS flags."""
    import numpy as np

    from areal_tpu_torch.api.data import SequenceSample

    rng = np.random.default_rng(seed)
    seqs = [list(o.prompt_ids) + list(o.output_ids) for o in outs]
    data = dict(
        packed_input_ids=np.concatenate(seqs).astype(np.int32),
        prompt_mask=np.concatenate([
            np.r_[np.ones(len(o.prompt_ids), bool), np.zeros(len(o.output_ids), bool)]
            for o in outs]),
        packed_logprobs=np.concatenate([
            np.r_[np.zeros(len(o.prompt_ids) - 1), o.output_logprobs]
            for o in outs]).astype(np.float32),
        rewards=rng.standard_normal(len(outs)).astype(np.float32),
        seq_no_eos_mask=np.array([float(o.no_eos) for o in outs], np.float32),
    )
    return SequenceSample.from_default(
        [len(s) for s in seqs], [o.qid for o in outs], data)


def _response_gap(sample, logp):
    """(mean, max) |logp - behaviour logprob| over response transitions
    (those whose target token is not a prompt token)."""
    import numpy as np

    lens = [l[0] for l in sample.seqlens["packed_input_ids"]]
    starts = np.cumsum([0] + lens[:-1])
    pm = sample.data["prompt_mask"]
    resp = np.concatenate([~pm[s + 1:s + L] for s, L in zip(starts, lens)])
    d = np.abs(logp - sample.data["packed_logprobs"])[resp]
    return float(d.mean()), float(d.max())


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def _device_profile(fn):
    """One call of ``fn`` under ``torch.profiler``, device activity only:
    (its result, device busy seconds, seconds in the flash kernels, the
    top device rows).  Tracing still slows the host, so the call's wall
    time is not a step time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        out = fn()
        torch.cuda.synchronize()
    busy, flash = device_seconds(prof, ("fa_", "seg_ranges_kernel"))
    top = top_device_rows(prof, 8)
    return out, busy, flash, top


def train_phase(cfg, master, serving0, device, outs, card, *, lr=TRAIN_LR,
                steps=TRAIN_STEPS, max_tokens_per_mb=MAX_TOKENS_PER_MB,
                serve_kw=None):
    """One async-PPO trainer iteration at the recipe's settings through
    ``PPOActorInterface``: actor_inf, then ``steps`` actor_train steps,
    with the flash kernels' launch counts set to 0 before and read after
    each; then the trained weights go back, through ``update_weights``, to
    a serving engine built on the version-0 serving weights ``serving0``.
    The trainer updates ``master`` in place."""
    import dataclasses

    import torch

    from areal_tpu_torch.api.data import MicroBatchSpec
    from areal_tpu_torch.api.model_api import FinetuneSpec, Model
    from areal_tpu_torch.engine.optimizer import OptimizerConfig
    from areal_tpu_torch.engine.sampling import SamplingParams
    from areal_tpu_torch.engine.train_engine import TrainEngine, tree_leaves
    from areal_tpu_torch.interfaces.ppo_interface import (
        PPOActorInterface,
        model_logprobs_fwd,
    )
    from areal_tpu_torch.ops.flash_attention import flash_attention as fa
    from areal_tpu_torch.system.flops_counter import train_flops

    tcfg = dataclasses.replace(cfg, remat=True)
    sample = rollout_sample(outs, SEED + 5)
    lens = [l[0] for l in sample.seqlens["packed_input_ids"]]
    engine = TrainEngine(
        tcfg, None, master,
        OptimizerConfig(lr=lr, warmup_steps_proportion=0.0), 100,
        pack_sequences=True, device=device,
    )
    model = Model("actor", engine, ft_spec=FinetuneSpec(1, len(lens), len(lens)))
    iface = PPOActorInterface(**PPO_RECIPE)
    mb_spec = MicroBatchSpec(max_tokens_per_mb=max_tokens_per_mb)
    L = cfg.n_layers
    log(f"train: rollout of {len(lens)} sequences, {sum(lens)} tokens "
        f"(lengths {lens}); TrainEngine float32 master weights + AdamW (lr "
        f"{lr}, no warm-up), remat, packing, {PPO_RECIPE}, "
        f"max_tokens_per_mb={max_tokens_per_mb}")

    # actor_inf: prox_logp at version 0
    fa.fwd_launches = fa.bwd_launches = 0
    tik = time.perf_counter()
    prox = iface.inference(model, sample, mb_spec)
    inf_s = time.perf_counter() - tik
    n_inf = engine.last_forward_mbs
    counts = (fa.fwd_launches, fa.bwd_launches)
    expected = (L * n_inf if device.type == "cuda" else 0, 0)
    log(f"train actor_inf: {n_inf} micro-batches in {inf_s:.2f} s; flash "
        f"launches fwd/bwd {counts}, expected {expected}")
    if counts != expected:
        raise AssertionError(f"actor_inf launched {counts}")
    mean, mx = _response_gap(sample, prox.data["prox_logp"])
    log(f"train check: version-0 |prox_logp - serving logprobs| over response "
        f"tokens: mean {mean:.3e} (tol {TOL_PROX_MEAN}), max {mx:.3e} (tol "
        f"{TOL_PROX_MAX})")
    if not (mean <= TOL_PROX_MEAN and mx <= TOL_PROX_MAX):
        raise AssertionError("trainer and serving logprobs disagree at version 0")
    # controls: faults of the trainer forward the gate must see, each read
    # against the same version-0 serving logprobs
    fwd = model_logprobs_fwd()
    controls = {
        "no RoPE (positions all 0)": lambda p, c, b: fwd(
            p, c, dict(b, positions=torch.zeros_like(b["positions"]))),
        "temperature 1.1": model_logprobs_fwd(1.1),
    }
    gaps = {name: _response_gap(sample, engine.forward_batch(
        sample, fn, mb_spec, output_shift=1)) for name, fn in controls.items()}
    sample.update_(prox)
    launches = dict(fwd=counts[0], bwd=counts[1])

    probe = [t for t in tree_leaves(engine.params) if t.dim() == 2][:4]
    before = [t.detach().to(torch.bfloat16).clone() for t in probe]
    step_stats = []
    cuda = device.type == "cuda"
    for step in range(steps):
        fa.fwd_launches = fa.bwd_launches = 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        profiled = cuda and step == steps - 1 and steps > 1
        tik = time.perf_counter()
        if profiled:
            st, busy, flash_s, top = _device_profile(
                lambda: iface.train_step(model, sample, mb_spec))
        else:
            st = iface.train_step(model, sample, mb_spec)
            _sync(device)
        wall = time.perf_counter() - tik
        counts = (fa.fwd_launches, fa.bwd_launches)
        n = int(st["n_mbs"])
        # the kernels launch on CUDA tensors only (plain version on the CPU)
        expected = (2 * L * n, L * n) if cuda else (0, 0)
        peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
        finite = all(math.isfinite(st[k]) for k in ("loss", "grad_norm"))
        line = (f"train actor_train step {step + 1}: {n} micro-batches over "
                f"{PPO_RECIPE['n_minibatches']} minibatches, loss {st['loss']:.6e}, "
                f"grad_norm {st['grad_norm']:.6e}, clip frac "
                f"{st['actor_clip_frac']:.4e}, approx_kl {st['approx_kl']:.4e}, "
                f"entropy {st['entropy']:.4e}; flash launches fwd/bwd {counts}, "
                f"expected {expected}; wall {wall:.3f} s, peak memory "
                f"{peak:.2f} GiB, padding share of the last minibatch's "
                f"[B, T] slots {engine.last_padding_frac:.3f}")
        if profiled:
            # idle share against the previous (unprofiled) step's wall time:
            # the same work, without the profiler's host overhead
            line += (f"; profiled (wall not a step time): device busy "
                     f"{busy:.3f} s (idle share {1 - busy / step_stats[-1]['wall']:.3f} "
                     f"of step {step}'s wall), flash kernels {flash_s:.3f} s = "
                     f"{flash_s / busy:.3f} of device time")
        log(line)
        if profiled:
            for sec, calls, name in top:
                log(f"train step {step + 1} device time: {sec:.4f} s in {calls} "
                    f"calls of {name}")
        if counts != expected or not finite:
            raise AssertionError(f"train step {step + 1}: launches {counts} "
                                 f"(expected {expected}), finite {finite}")
        launches["fwd"] += counts[0]
        launches["bwd"] += counts[1]
        step_stats.append(dict(wall=wall, peak=peak, n_mbs=n,
                               **({"busy": busy, "flash": flash_s} if profiled else {})))
    moved = [float((t.detach().to(torch.bfloat16) != b).float().mean())
             for t, b in zip(probe, before)]
    log(f"train check: share of bf16-cast weights moved in {len(probe)} "
        f"matrices after {steps} steps: {[f'{m:.3f}' for m in moved]}")
    if not all(m > 0 for m in moved):
        raise AssertionError("training did not move the weights")
    gaps[f"weights {steps} steps on"] = _response_gap(
        sample, engine.forward_batch(sample, fwd, mb_spec, output_shift=1))
    timed = step_stats[1] if steps > 2 else step_stats[-1]
    tok_s = sum(lens) / timed["wall"]
    mfu = train_flops(tcfg, lens) / timed["wall"] / BF16_FLOPS
    log(f"train throughput on {card}: step {2 if steps > 2 else steps} "
        f"{timed['wall']:.3f} s, {tok_s:.1f} trained tokens/s, MFU {mfu:.4f} "
        f"(train_flops {train_flops(tcfg, lens):.4e} / step time / 989 "
        f"TFLOP/s), peak memory {timed['peak']:.2f} GiB; actor_inf "
        f"{sum(lens) / inf_s:.1f} tokens/s")

    # close the loop: the trained weights served, its logprobs recomputed
    eng = build_engine(cfg, serving0, device, SamplingParams(greedy=True),
                       **(serve_kw or {}))
    eng.update_weights(engine.params, version=steps)
    prompt = make_prompts(cfg.vocab_size, [300], SEED + 6)
    (o,), _ = serve(eng, requests(prompt, 32, "trained"))
    if o.version_start != steps:
        raise AssertionError("update_weights did not stamp the trained version")
    one = rollout_sample([o], SEED)
    logp = engine.forward_batch(one, model_logprobs_fwd(), mb_spec,
                                output_shift=1)
    mean2, mx2 = _response_gap(one, logp)
    log(f"train check: after update_weights, |trainer logprobs - serving "
        f"logprobs| over {len(o.output_ids)} generated tokens: mean "
        f"{mean2:.3e}, max {mx2:.3e} (tol {TOL_PROX_MEAN}, {TOL_PROX_MAX})")
    if not (mean2 <= TOL_PROX_MEAN and mx2 <= TOL_PROX_MAX):
        raise AssertionError("served trained weights disagree with the trainer")
    if eng.close():
        raise AssertionError("the trained-weights engine leaked pool blocks")
    for name, (cm, cx) in gaps.items():
        log(f"train control: trainer forward with {name} against the "
            f"version-0 serving logprobs: mean {cm:.3e}, max {cx:.3e} (the "
            f"gate fails it at mean > {TOL_PROX_MEAN} or max > {TOL_PROX_MAX})")
    unseen = [n for n, (cm, cx) in gaps.items()
              if cm <= TOL_PROX_MEAN and cx <= TOL_PROX_MAX]
    if unseen:
        raise AssertionError(f"the logprob gate does not see: {unseen}")
    return dict(launches=launches, step_s=timed["wall"], tok_s=tok_s, mfu=mfu,
                peak_gib=timed["peak"], steps=step_stats)


def _gap_gate(what, gap, tol_mean, tol_max, phase="long"):
    mean, mx = gap
    ok = mean <= tol_mean and mx <= tol_max
    log(f"{phase} check: {what}: |trainer logprobs - serving logprobs| over "
        f"response tokens: mean {mean:.3e} (tol {tol_mean}), max {mx:.3e} "
        f"(tol {tol_max}){'' if ok else ' FAILS'}")
    return ok


def _first_divergence(a, b):
    """(agreeing positions, index of the first differing position or
    None) of two token lists."""
    same = sum(x == y for x, y in zip(a, b))
    first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if first is None and len(a) != len(b):
        first = min(len(a), len(b))
    return same, first


def long_context_phase(cfg, master, params, device, card, *,
                       prompt_lens=LONG_PROMPT_LENS, new_tokens=LONG_NEW_TOKENS,
                       arms=LONG_ARMS, max_batch=LONG_MAX_BATCH,
                       kv_cache_len=LONG_KV_CACHE_LEN, control_lens=None):
    """The recipe's serving configuration (``max_batch=16``,
    ``kv_cache_len=32768``) over a greedy wave of ``prompt_lens``, in the
    arms of ``arms``: A, a bf16 pool on the default dispatch table; B, the
    same with ``deep_min_context=8192``; C, an int8 pool with that table.
    In every arm: prefill and decode tokens/s, the pool's bytes, the
    kernels' launch counts against the dispatched work (counts set to 0
    just before the wave, read just after), zero leaked blocks, and the
    logprobs of the arm's tokens against the trainer forward of the
    version-0 master weights ``master`` on the same tokens.  Then a broken
    int8 arm (V dequantized at twice its scale) on a shorter wave, which
    the int8 gate must fail, and the tokens of B and C against A's."""
    import torch

    from areal_tpu_torch.api.data import MicroBatchSpec
    from areal_tpu_torch.engine.dispatch import resolve_dispatch_table
    from areal_tpu_torch.engine.sampling import SamplingParams
    from areal_tpu_torch.engine.train_engine import TrainEngine
    from areal_tpu_torch.interfaces.ppo_interface import model_logprobs_fwd
    from areal_tpu_torch.models import paged
    from areal_tpu_torch.ops.paged_attention import (
        paged_flash_attention as std,
    )
    from areal_tpu_torch.ops.paged_attention import (
        paged_flash_attention_deep as deep,
    )

    L = cfg.n_layers
    prompts = make_prompts(cfg.vocab_size, prompt_lens, SEED + 11)
    # forward only: no optimizer state; the tree is shared, not copied
    trainer = TrainEngine(cfg, None, master, device=device)
    mb_spec = MicroBatchSpec(max_tokens_per_mb=kv_cache_len)

    def gap_of(outs):
        sample = rollout_sample(outs, SEED)
        logp = trainer.forward_batch(sample, model_logprobs_fwd(), mb_spec,
                                     output_shift=1)
        return _response_gap(sample, logp)

    def engine(kv_dtype, deep_min):
        return build_engine(
            cfg, params, device, SamplingParams(greedy=True),
            max_batch=max_batch, kv_cache_len=kv_cache_len,
            kv_cache_dtype=kv_dtype,
            dispatch_table=resolve_dispatch_table(None, deep_min),
        )

    log(f"long: {len(prompts)} requests, prompts {list(prompt_lens)} "
        f"({sum(prompt_lens)} tokens), {new_tokens} new tokens each; "
        f"max_batch={max_batch}, kv_cache_len={kv_cache_len}, page "
        f"{PAGE_SIZE}, prefill chunk {PREFILL_CHUNK}, chunk {CHUNK_SIZE}, "
        f"pipeline depth {PIPELINE_DEPTH}")
    results = {}
    for name, kv_dtype, deep_min in arms:
        eng = engine(kv_dtype, deep_min)
        int8 = kv_dtype == "int8"
        pool_bytes = eng.kv_pool_bytes + eng.kv_scale_bytes
        pool_gib = pool_bytes / 2**30
        p0 = eng.prefill_tokens_total
        _, prefill_secs = serve(eng, requests(prompts, 1, f"{name}-first"))
        prefill_tps = (eng.prefill_tokens_total - p0) / prefill_secs

        f0, d0 = eng.prefill_calls, eng.decode_chunks_total
        dd0, t0 = eng.deep_decode_chunks_total, eng.decode_tokens_total
        for fn in (std, deep):
            fn.launches = fn.int8_launches = 0
        std.prefill_launches = 0
        outs, secs = serve(eng, requests(prompts, new_tokens, f"{name}-greedy"))
        counts = {f"{fn.__name__}.{k}": getattr(fn, k)
                  for fn in (std, deep) for k in ("launches", "int8_launches")}
        counts[f"{std.__name__}.prefill_launches"] = std.prefill_launches
        fills = eng.prefill_calls - f0
        chunks = eng.decode_chunks_total - d0
        deep_chunks = eng.deep_decode_chunks_total - dd0
        dec_tok = eng.decode_tokens_total - t0
        decode_tps = dec_tok / (secs - prefill_secs)
        check_outputs(outs, cfg, new_tokens, f"long {name}")
        key = "int8_launches" if int8 else "launches"
        other = "launches" if int8 else "int8_launches"
        got_std, got_deep = getattr(std, key), getattr(deep, key)
        want_std = L * (fills + eng.chunk_size * (chunks - deep_chunks))
        want_deep = L * eng.chunk_size * deep_chunks
        log(f"long {name} ({kv_dtype} pool, {pool_bytes} bytes = "
            f"{pool_gib:.2f} GiB, "
            f"deep_min_context={eng.dispatch_table.deep_min_context}): "
            f"{sum(len(o.output_ids) for o in outs)} new tokens in {secs:.2f} s; "
            f"{fills} fill chunks, {chunks} decode chunks ({deep_chunks} deep); "
            f"launches {counts}; expected standard {want_std} ({L * fills} "
            f"on the prefill entry), deep {want_deep}")
        log(f"long {name} throughput on {card}: prefill {prefill_tps:.1f} "
            f"tok/s (first-token wave, {prefill_secs:.2f} s), decode "
            f"{decode_tps:.1f} tok/s ({dec_tok} decode-chunk tokens)")
        decode_launches = (got_std - L * fills) + got_deep
        if (got_std != want_std or got_deep != want_deep
                or decode_launches != L * eng.chunk_size * chunks
                or getattr(std, other) or getattr(deep, other)
                or got_std == 0 or std.prefill_launches != L * fills):
            raise AssertionError(f"long {name}: kernel launches {counts} do "
                                 f"not match the dispatched work")
        if (deep_chunks > 0) != (deep_min is not None):
            raise AssertionError(f"long {name}: {deep_chunks} deep decode "
                                 "chunks")
        if deep_chunks:
            q_like = torch.empty((), dtype=getattr(torch, cfg.dtype))
            log(f"long {name}: its {deep_chunks} deep decode chunks ran the "
                f"{deep_route(q_like, eng.k_pool[0], eng.k_scale)}")
        audit_pool(eng, f"long {name}")
        del eng
        torch.cuda.empty_cache()
        gap = gap_of(outs)
        tol = (TOL_INT8_MEAN, TOL_INT8_MAX) if int8 else (
            TOL_PROX_MEAN, TOL_PROX_MAX)
        if not _gap_gate(f"arm {name}", gap, *tol):
            raise AssertionError(f"long {name}: serving and trainer "
                                 "logprobs disagree")
        results[name] = dict(
            outs=outs, prefill_tps=prefill_tps, decode_tps=decode_tps,
            gap=gap, pool_bytes=pool_bytes, fills=fills, chunks=chunks,
            deep_chunks=deep_chunks,
            launches=dict(std=got_std, deep=got_deep,
                          prefill=std.prefill_launches),
            int8=int8, secs=secs, prefill_secs=prefill_secs,
        )
        log(f"long {name}: leak check and logprob gate pass; done at "
            f"{secs + prefill_secs:.1f} s of serving")

    # the broken control: an int8 arm whose reads dequantize V at twice
    # its scale, on a shorter wave
    control = LONG_CONTROL_LENS if control_lens is None else control_lens
    real = paged._prefix_partials

    def broken(q, k_pool, v_pool, tables, lengths, layer, deep=False,
               k_scale=None, v_scale=None, verify=False):
        return real(q, k_pool, v_pool, tables, lengths, layer, deep=deep,
                    k_scale=k_scale, v_scale=v_scale * 2, verify=verify)

    eng = engine("int8", DEEP_MIN_CONTEXT)
    paged._prefix_partials = broken
    try:
        bad, _ = serve(eng, requests(
            make_prompts(cfg.vocab_size, control, SEED + 12),
            LONG_CONTROL_NEW_TOKENS, "control"))
    finally:
        paged._prefix_partials = real
    if eng.close():
        raise AssertionError("the control engine leaked pool blocks")
    del eng
    torch.cuda.empty_cache()
    cgap = gap_of(bad)
    if _gap_gate(f"control (int8 pool, V dequantized at 2x its scale, "
                 f"prompts {control})", cgap, TOL_INT8_MEAN, TOL_INT8_MAX):
        raise AssertionError("the int8 logprob gate does not see V scales "
                             "off by 2x")
    results["control_gap"] = cgap

    if "A" in results:
        ref = results["A"]["outs"]
        for name in ("B", "C"):
            if name not in results:
                continue
            pairs = [_first_divergence(a.output_ids, b.output_ids)
                     for a, b in zip(ref, results[name]["outs"])]
            agree = sum(s for s, _ in pairs)
            total = sum(len(a.output_ids) for a in ref)
            firsts = [f for _, f in pairs]
            log(f"long check: arm {name} agrees with arm A at {agree} of "
                f"{total} token positions; {sum(f is None for f in firsts)} "
                f"of {len(firsts)} streams identical; first divergence per "
                f"request {firsts}")
            results[name]["agree"] = (agree, total, firsts)
    return results


class LaunchGate:
    """The paged kernels' launch counts on one engine path: set to 0 just
    before the path (:meth:`start`), read just after (:meth:`check`), and
    held against the work the engine dispatched in between, from its own
    counters: every fill chunk, every decode step and every speculative
    verify window runs the kernel once per layer; a fill chunk on the
    prefill entry unless its widest row is one token, and a verify window
    (two tokens or more) always on it, where the tensor-core prefill entry
    takes the dtypes (``tensor_cores``: bf16 q; float32 runs the decode
    entry throughout); decode chunks on the deep kernel when routed there.
    Verify windows' launches also count on ``verify_launches``."""

    def __init__(self, eng, L, int8, tensor_cores=True):
        self.eng, self.L, self.int8 = eng, L, int8
        self.tensor_cores = tensor_cores
        self.total = dict(std=0, deep=0, prefill=0, verify=0)

    def _work(self):
        e = self.eng
        return (e.prefill_calls, e.one_token_fill_calls,
                e.decode_chunks_total, e.deep_decode_chunks_total,
                e.spec_verify_chunks_total)

    def start(self):
        from areal_tpu_torch.ops import paged_attention as pa

        for fn in (pa.paged_flash_attention, pa.paged_flash_attention_deep):
            fn.launches = fn.int8_launches = 0
        pa.paged_flash_attention.prefill_launches = 0
        pa.paged_flash_attention.verify_launches = 0
        self.w0 = self._work()

    def check(self, what):
        from areal_tpu_torch.ops import paged_attention as pa

        std, deep = pa.paged_flash_attention, pa.paged_flash_attention_deep
        fills, one, chunks, deep_chunks, verifies = (
            b - a for a, b in zip(self.w0, self._work()))
        L, W = self.L, self.eng.chunk_size
        key, other = (("int8_launches", "launches") if self.int8
                      else ("launches", "int8_launches"))
        got = dict(std=getattr(std, key), deep=getattr(deep, key),
                   prefill=std.prefill_launches, verify=std.verify_launches)
        want = dict(std=L * (fills + W * (chunks - deep_chunks) + verifies),
                    deep=L * W * deep_chunks,
                    prefill=(L * (fills - one + verifies)
                             if self.tensor_cores else 0),
                    verify=L * verifies)
        log(f"{what}: {fills} fill chunks ({one} of one token), {chunks} "
            f"decode chunks ({deep_chunks} deep), {verifies} verify windows; "
            f"paged launches {got}, expected {want}")
        if (got != want or getattr(std, other) or getattr(deep, other)
                or got["std"] == 0):
            raise AssertionError(f"{what}: kernel launches {got} do not match "
                                 f"the dispatched work {want}")
        for k in self.total:
            self.total[k] += got[k]
        return dict(fills=fills, chunks=chunks, verifies=verifies)


def prefix_phase(cfg, master, params, device, card, *, kv_dtype="auto",
                 group=PREFIX_GROUP, prompt_len=PREFIX_PROMPT,
                 suffix_len=PREFIX_SUFFIX, new_tokens=PREFIX_NEW_TOKENS,
                 rounds=PREFIX_ROUNDS, shared_new=PREFIX_SHARED_NEW_TOKENS,
                 swap_after=PREFIX_SWAP_AFTER, max_batch=LONG_MAX_BATCH,
                 kv_cache_len=LONG_KV_CACHE_LEN,
                 pressure_lens=PRESSURE_PROMPT_LENS,
                 pressure_batch=PRESSURE_MAX_BATCH,
                 pressure_kv=PRESSURE_KV_CACHE_LEN,
                 pressure_pool=PRESSURE_POOL_TOKENS,
                 pressure_new=PRESSURE_NEW_TOKENS, mb_tokens=None,
                 **engine_kw):
    """The radix prefix cache, group-prompt block sharing, parking and
    preemption at the recipe's serving shape, on a ``kv_dtype`` pool, with
    keyed sampling at temperature 1:

    1. a group wave: ``group`` requests over one ``prompt_len``-token
       prompt prefill it once and copy its tail block per member;
    2. ``rounds`` rounds of continuations (each answer resubmitted under
       its qid) resume parked rows with no prefill;
    3. a second group whose prompt extends the first by ``suffix_len``
       tokens evicts the parked rows and prefills only the suffix; two
       weight swaps to the same perturbed weights while it decodes flush
       the cache, recompute the shared blocks, and leave their bytes
       bit-identical from one swap to the next;
    4. a pressure arm: ``pressure_pool`` tokens of pool (a quarter of the
       dense ``pressure_batch x pressure_kv``) under prompts of
       ``pressure_lens`` preempts and completes every request.

    Each path checks its launches against the dispatched work
    (:class:`LaunchGate`) and its logprobs against the trainer forward;
    each engine ends with the leak audit (:func:`audit_pool`)."""
    import dataclasses

    import torch

    from areal_tpu_torch.api.data import MicroBatchSpec
    from areal_tpu_torch.engine.sampling import SamplingParams
    from areal_tpu_torch.engine.train_engine import TrainEngine
    from areal_tpu_torch.interfaces.ppo_interface import model_logprobs_fwd

    L = cfg.n_layers
    int8 = kv_dtype == "int8"
    tol = (TOL_INT8_MEAN, TOL_INT8_MAX) if int8 else (TOL_PROX_MEAN,
                                                       TOL_PROX_MAX)
    tag = f"prefix {kv_dtype} pool"
    mb_spec = MicroBatchSpec(max_tokens_per_mb=mb_tokens or kv_cache_len)
    sampling = SamplingParams(temperature=1.0)

    trainers = {}

    def gate(what, outs, weights=master):
        # forward only: no optimizer state; the tree is shared, not copied
        if id(weights) not in trainers:
            trainers[id(weights)] = TrainEngine(cfg, None, weights,
                                                device=device)
        trainer = trainers[id(weights)]
        sample = rollout_sample(outs, SEED)
        gap = _response_gap(sample, trainer.forward_batch(
            sample, model_logprobs_fwd(), mb_spec, output_shift=1))
        if not _gap_gate(f"{tag}, {what}", gap, *tol, phase="prefix"):
            raise AssertionError(f"{tag}, {what}: serving and trainer "
                                 "logprobs disagree")
        return gap

    def stats(eng):
        st = eng.prefix_cache_stats()
        return dict(prefill=eng.prefill_tokens_total, calls=eng.prefill_calls,
                    copies=eng.block_copies_total, resumed=eng.resumed_total,
                    preempted=eng.preempted_total, hits=st["hits_total"],
                    cached=st["cached_tokens_total"],
                    flushes=st["flushes_total"])

    def delta(a, b):
        return {k: b[k] - a[k] for k in a}

    eng = build_engine(cfg, params, device, sampling, max_batch=max_batch,
                       kv_cache_len=kv_cache_len, kv_cache_dtype=kv_dtype,
                       prefix_cache=True, **engine_kw)
    launches = LaunchGate(eng, L, int8)
    res = {}
    p1 = make_prompts(cfg.vocab_size, [prompt_len], SEED + 31)[0]

    # 1. the group wave
    s0 = stats(eng)
    launches.start()
    outs, secs = serve(eng, requests([p1] * group, new_tokens, "g"))
    launches.check(f"{tag}, group wave")
    check_outputs(outs, cfg, new_tokens, f"{tag} group")
    d = delta(s0, stats(eng))
    log(f"{tag}, group wave: {group} requests over one {prompt_len}-token "
        f"prompt: {d['prefill']} prompt tokens prefilled of "
        f"{group * prompt_len} submitted, {d['copies']} tail blocks copied, "
        f"{sum(len(o.output_ids) for o in outs)} new tokens, wall "
        f"{secs:.2f} s on {card}")
    if d["prefill"] != prompt_len or d["copies"] != group - 1:
        raise AssertionError(f"{tag}, group wave: {d}")
    res["group"] = dict(secs=secs, prefilled=d["prefill"],
                        submitted=group * prompt_len, copies=d["copies"],
                        gap=gate("group wave", outs))

    # 2. continuations resume the parked rows
    for r in range(rounds):
        s0 = stats(eng)
        launches.start()
        outs, secs = serve(eng, requests(
            [list(o.prompt_ids) + list(o.output_ids) for o in outs],
            new_tokens, "g"))
        launches.check(f"{tag}, continuation round {r + 1}")
        check_outputs(outs, cfg, new_tokens, f"{tag} continuation")
        d = delta(s0, stats(eng))
        log(f"{tag}, continuation round {r + 1}: {d['resumed']} resumed, "
            f"{d['prefill']} tokens prefilled in {d['calls']} fill chunks, "
            f"wall {secs:.2f} s")
        if d["resumed"] != group or d["prefill"] or d["calls"]:
            raise AssertionError(f"{tag}, continuation round {r + 1}: {d}")
    res["continuation_gap"] = gate(f"continuation round {rounds}", outs)
    if eng.n_parked != group:
        raise AssertionError(f"{tag}: {eng.n_parked} parked rows")

    # 3. a shared system prompt: a second group over p1 + a suffix
    p2 = p1 + make_prompts(cfg.vocab_size, [suffix_len], SEED + 32)[0]
    reqs = requests([p2] * group, shared_new, "s")
    s0 = stats(eng)
    launches.start()
    tik = time.perf_counter()
    for q in reqs:
        eng.submit(q)
    while eng.n_decoding < group:
        eng.step()
    d = delta(s0, stats(eng))
    log(f"{tag}, shared-prefix group: {d['prefill']} tokens prefilled of a "
        f"{len(p2)}-token prompt, {d['cached']} served from the cache, "
        f"{eng.n_parked} parked rows left")
    if (d["prefill"] != suffix_len or d["cached"] != prompt_len
            or d["hits"] != 1 or eng.n_parked):
        raise AssertionError(f"{tag}, shared-prefix group: {d}")
    rids = [i for i, r in enumerate(eng.rows)
            if r is not None and r.req.qid.startswith("s-")]
    rows = [eng.rows[i] for i in rids]
    while min(len(r.generated) for r in rows) < swap_after:
        eng.step()
    n_full = len(p2) // eng.page_size
    shared = sorted({b for i in rids for b in eng._row_blocks[i][:n_full]})
    if any(eng._block_ref[b] < group for b in shared):
        raise AssertionError(f"{tag}: the group's full blocks are not shared")

    def shared_bytes():
        return [t[:, shared].clone() for t in
                (eng.k_pool, eng.v_pool, eng.k_scale, eng.v_scale)
                if t is not None]

    before = shared_bytes()
    w1 = _perturbed(master, SEED + 33)
    copies = []
    for version in (1, 2):
        eng.update_weights(w1, version=version)
        eng.step()  # the swap applies between chunks
        if version == 1:
            at_swap = {r.req.qid: len(r.generated) for r in rows}
        copies.append(shared_bytes())
    if eng.prefix_cache_stats()["flushes_total"] != s0["flushes"] + 2:
        raise AssertionError(f"{tag}: the swaps did not flush the cache")
    moved = not all(torch.equal(a, b) for a, b in zip(before, copies[0]))
    same = all(torch.equal(a, b) for a, b in zip(*copies))
    log(f"{tag}, weight swaps while the group decodes ({len(shared)} shared "
        f"blocks, {min(at_swap.values())}-{max(at_swap.values())} tokens "
        f"generated at the first): the first recomputed the shared blocks "
        f"({moved}); the second left their bytes bit-identical ({same})")
    if not (moved and same):
        raise AssertionError(f"{tag}: shared blocks after the swaps: "
                             f"recomputed {moved}, repeat identical {same}")
    while eng.has_work:
        eng.step()
    _sync(device)
    secs = time.perf_counter() - tik
    res_outs = eng.drain_results()
    outs = [res_outs.pop(q.qid) for q in reqs]
    launches.check(f"{tag}, shared-prefix group with two weight swaps")
    check_outputs(outs, cfg, shared_new, f"{tag} shared")
    if any(o.version_end != 2 for o in outs):
        raise AssertionError(f"{tag}: the shared group missed the swaps")
    # the tokens sampled after the first swap, against the trainer forward
    # of the swapped-in weights
    post = [dataclasses.replace(
        o, prompt_ids=list(o.prompt_ids) + o.output_ids[:at_swap[o.qid]],
        output_ids=o.output_ids[at_swap[o.qid]:],
        output_logprobs=o.output_logprobs[at_swap[o.qid]:]) for o in outs]
    res["shared"] = dict(secs=secs, prefilled=d["prefill"],
                         cached=d["cached"],
                         gap=gate("shared group after the swaps", post, w1))
    res["launches"] = dict(launches.total)
    audit_pool(eng, tag)
    del eng
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # 4. the pressure arm
    eng = build_engine(cfg, params, device, sampling,
                       max_batch=pressure_batch,
                       kv_cache_len=pressure_kv, kv_pool_tokens=pressure_pool,
                       kv_cache_dtype=kv_dtype, prefix_cache=True, **engine_kw)
    gate_p = LaunchGate(eng, L, int8)
    prompts = make_prompts(cfg.vocab_size, pressure_lens, SEED + 34)
    gate_p.start()
    outs, secs = serve(eng, requests(prompts, pressure_new, "pressure"))
    work = gate_p.check(f"{tag}, pressure arm")
    check_outputs(outs, cfg, pressure_new, f"{tag} pressure")
    n_tok = sum(len(o.output_ids) for o in outs)
    log(f"{tag}, pressure arm ({eng.n_blocks} blocks of {eng.page_size} for "
        f"{pressure_batch} rows x {pressure_kv}): {len(outs)} requests, prompts "
        f"{sum(pressure_lens)} tokens, {n_tok} new tokens in {secs:.2f} s; "
        f"{eng.preempted_total} preemptions, {eng.prefill_tokens_total} "
        f"tokens prefilled in {work['fills']} fill chunks, "
        f"{eng.prefix_cache_stats()['evictions_total']} cache evictions")
    if eng.preempted_total < 1 or n_tok != len(outs) * pressure_new:
        raise AssertionError(f"{tag}, pressure arm: {eng.preempted_total} "
                             f"preemptions, {n_tok} tokens")
    res["pressure"] = dict(secs=secs, preempted=eng.preempted_total,
                           prefilled=eng.prefill_tokens_total,
                           gap=gate("pressure arm", outs))
    for k in launches.total:
        res["launches"][k] += gate_p.total[k]
    audit_pool(eng, f"{tag}, pressure arm")
    del eng
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return res


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def server_phase(cfg, master, device, card, *, group=PREFIX_GROUP,
                 prompt_len=PREFIX_PROMPT, new_tokens=SERVER_NEW_TOKENS,
                 cont_new=SERVER_CONT_NEW_TOKENS, max_batch=LONG_MAX_BATCH,
                 kv_cache_len=LONG_KV_CACHE_LEN, mb_tokens=None,
                 **server_kw):
    """The train-to-serve weight path through the generation server, as the
    gserver manager drives it (stage on every server, pause, commit,
    resume):

    1. publish the trained float32 ``master`` as version 1
       (``checkpoint.save_params`` cast to bf16 with ``wait=False``, then
       ``wait_for_saves`` and ``write_manifest``) into a temporary
       directory, and its version under ``names.model_version``;
    2. start ``GenerationServerWorker`` in a thread (memory name_resolve,
       the GenServerConfig defaults with ``max_concurrent_batch`` and
       ``kv_cache_len`` of the recipe), its engine at version 0 from
       ``SEED``, the same weights as the earlier phases';
    3. send ``group`` requests over one ``prompt_len``-token prompt through
       ``GenServerClient`` (temperature 1, ``new_tokens`` each), stage v1
       while they decode (the server counts the decode steps its poll loop
       enqueued while the stage thread restored, and there must be some),
       check the staged tree bit-identical to the serving
       copy of the published weights, then pause, commit, resume and time
       the first token under v1; a second commit must be acknowledged;
    4. continue every answer under v1 (``cont_new`` tokens); stage a
       snapshot whose manifest alters one leaf's shape, which must fail
       before any tensor is read, name the leaf, and leave v1 serving.

    Gates: every token's version; logprobs of v0 tokens against the trainer
    forward of the v0 weights and of v1 tokens against that of ``master``;
    the paged launches against the engine's dispatched work
    (:class:`LaunchGate`); the metrics reply's SLO digests and swap
    counters; the leak audit once the server has stopped.  ``server_kw``
    overrides GenServerConfig fields (CPU rehearsals)."""
    import dataclasses
    import os
    import pickle
    import shutil
    import tempfile
    import threading

    import torch

    from areal_tpu_torch.api.config import ModelAbstraction
    from areal_tpu_torch.api.data import MicroBatchSpec
    from areal_tpu_torch.api.model_api import (
        APIGenerateInput,
        GenerationHyperparameters,
    )
    from areal_tpu_torch.api.system_api import GenServerConfig
    from areal_tpu_torch.base import constants, name_resolve, names
    from areal_tpu_torch.engine import checkpoint
    from areal_tpu_torch.engine.train_engine import TrainEngine
    from areal_tpu_torch.interfaces.ppo_interface import model_logprobs_fwd
    from areal_tpu_torch.models.convert import serving_params
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.ops import paged_attention as pa
    from areal_tpu_torch.system.generation_server import (
        GenerationServerWorker,
        GenServerClient,
        parse_server_registration,
    )

    tag = "server"
    t_phase = time.perf_counter()
    res = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_publish_")
    worker = client = thread = None
    try:
        # 1. publish v1
        snap = os.path.join(tmp, "v1")
        _sync(device)
        tik = time.perf_counter()
        checkpoint.save_params(master, snap, cast_dtype=torch.bfloat16,
                               wait=False)
        t_snapshot = time.perf_counter() - tik
        checkpoint.wait_for_saves()
        published_meta = _tree_map(
            lambda x: torch.empty(x.shape, dtype=torch.bfloat16,
                                  device="meta"), master)
        checkpoint.write_manifest(published_meta, snap, version=1)
        t_publish = time.perf_counter() - tik
        nbytes = os.path.getsize(os.path.join(snap, checkpoint.TENSORS_NAME))
        name_resolve.reconfigure("memory")
        constants.set_experiment_trial_names("chipsmoke", "server")
        name_resolve.add(
            names.model_version("chipsmoke", "server", "actor"),
            pickle.dumps({"version": 1, "path": snap,
                          "format": "params"}).hex(), replace=True)
        log(f"{tag}: published v1 ({nbytes / 1e9:.3f} GB of bf16) in "
            f"{t_publish:.3f} s (save_params returned after "
            f"{t_snapshot:.3f} s, the write ran on a background thread) on "
            f"{card}")

        # 2. the server
        config = GenServerConfig(
            worker_name="gen_server_0",
            model=ModelAbstraction("random", {"config": cfg, "seed": SEED}),
            max_concurrent_batch=max_batch, kv_cache_len=kv_cache_len,
            device=None if device.type == "cuda" else str(device),
            **server_kw)
        tik = time.perf_counter()
        worker = GenerationServerWorker()
        failed = []

        def run_server():
            try:
                worker.run(config)
            except Exception as e:  # noqa: BLE001 - raised below
                failed.append(e)

        thread = threading.Thread(target=run_server, daemon=True,
                                  name="gen-server")
        thread.start()
        key = names.gen_server("chipsmoke", "server", "gen_server_0")
        while True:
            try:
                addr = parse_server_registration(name_resolve.get(key))[0]
                break
            except name_resolve.NameEntryNotFoundError:
                if not thread.is_alive() or time.perf_counter() - tik > 300:
                    raise AssertionError(
                        f"{tag}: the server did not start: {failed}")
                time.sleep(0.01)
        client = GenServerClient(addr, timeout=600)
        eng = worker.engine
        log(f"{tag}: GenerationServerWorker at {addr} in "
            f"{time.perf_counter() - tik:.1f} s: {eng.max_batch} rows x "
            f"{eng.kv_cache_len} tokens, pages of {eng.page_size}, decode "
            f"chunks of {eng.chunk_size}, {eng.n_blocks} pool blocks, prefix "
            f"cache {eng._prefix_cache is not None}, SLO records "
            f"{eng._slo_enabled}, temperature {eng.sampling.temperature}")
        if eng.version != 0 or eng.device.type != device.type:
            raise AssertionError(f"{tag}: engine at v{eng.version} on "
                                 f"{eng.device}")

        def generate_all(prompts, budget, qtag):
            outs = [None] * len(prompts)
            errs = []

            def one(i):
                try:
                    outs[i] = client.generate(APIGenerateInput(
                        qid=f"{qtag}-{i}", prompt_ids=prompts[i],
                        input_ids=prompts[i],
                        gconfig=GenerationHyperparameters(
                            max_new_tokens=budget)))
                except Exception as e:  # noqa: BLE001 - raised below
                    errs.append(e)

            threads = [threading.Thread(target=one, args=(i,))
                       for i in range(len(prompts))]
            for t in threads:
                t.start()
            return outs, threads, errs

        def collect(outs, threads, errs, what):
            for t in threads:
                t.join(600)
            if errs or any(o is None for o in outs):
                raise AssertionError(f"{tag}, {what}: {errs or 'lost replies'}")
            return outs

        # 3. the group, the stage while it decodes, pause/commit/resume
        prompt = make_prompts(cfg.vocab_size, [prompt_len], SEED + 41)[0]
        launches = LaunchGate(eng, cfg.n_layers, False)
        launches.start()
        # the engine is idle here, so the counters agree with each other
        s0 = (eng.decode_steps_total, eng.prefill_calls)
        tik = time.perf_counter()
        pending = generate_all([prompt] * group, new_tokens, "group")
        while eng.decode_chunks_total == 0:
            if not thread.is_alive():
                raise AssertionError(f"{tag}: the server died: {failed}")
            time.sleep(0.001)
        w0 = (eng.decode_steps_total, eng.decode_chunks_total,
              eng.decode_tokens_total, eng.prefill_calls,
              pa.paged_flash_attention.launches)
        t_stage0 = time.perf_counter()
        reply = client.call("update_weights", {
            "path": snap, "version": 1, "format": "params", "mode": "stage"})
        t_stage = time.perf_counter() - t_stage0
        w1 = (eng.decode_steps_total, eng.decode_chunks_total,
              eng.decode_tokens_total, eng.prefill_calls,
              pa.paged_flash_attention.launches)
        steps, chunks, toks, fills, calls = (b - a for a, b in zip(w0, w1))
        log(f"{tag}: stage v1: {t_stage:.3f} s request to reply (server "
            f"{reply['stage_seconds']} s), meanwhile {steps} decode steps "
            f"enqueued ({chunks} decode chunks dispatched, {toks} tokens "
            f"harvested, {fills} fill chunks; {calls} paged kernel calls); "
            f"while the stage thread restored: "
            f"{reply['decode_steps_during_stage']} decode steps enqueued, "
            f"{reply['decode_tokens_during_stage']} tokens harvested, on "
            f"{card}")
        if reply.get("staged") != 1 or eng.staged_version != 1:
            raise AssertionError(f"{tag}: stage reply {reply}")
        # read by the server from its stage thread's start to its end: a
        # stage that held the poll loop would show no step
        if reply["decode_steps_during_stage"] < 1:
            raise AssertionError(f"{tag}: decoding did not go on during the "
                                 f"restore ({reply})")
        # the staged tree is the serving copy of what was published
        want = serving_params(_tree_map(lambda x: x.to(torch.bfloat16),
                                        master), cfg)
        staged = list(_leaves(eng._staged_params))
        same = all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(staged, _leaves(want)))
        n_leaves = len(staged)
        del want, staged
        log(f"{tag}: the staged tree is bit-identical to serving_params of "
            f"the published weights ({n_leaves} leaves): {same}")
        if not same:
            raise AssertionError(f"{tag}: the staged tree differs")
        if client.call("pause", {}) != "paused":
            raise AssertionError(f"{tag}: pause")
        # the paged calls from the group's start to the pause, the stage
        # inside: the server takes a command between steps, and a paused
        # engine only drains, so these counters stand still now (read while
        # a step is enqueued, as around the stage above, a count can be a
        # layer ahead of the steps)
        steps = eng.decode_steps_total - s0[0]
        fills = eng.prefill_calls - s0[1]
        calls = pa.paged_flash_attention.launches
        log(f"{tag}: from the group's start to the pause: {steps} decode "
            f"steps and {fills} fill chunks enqueued, {calls} paged kernel "
            f"calls")
        if calls != cfg.n_layers * (steps + fills):
            raise AssertionError(f"{tag}: {calls} paged calls from the "
                                 f"group's start to the pause for {steps} "
                                 f"decode steps and {fills} fills")
        t_commit0 = time.perf_counter()
        reply = client.call("update_weights", {
            "path": snap, "version": 1, "format": "params", "mode": "commit"})
        if client.call("resume", {}) != "resumed":
            raise AssertionError(f"{tag}: resume")
        interrupted = reply["num_interrupted"]
        t_first_v1 = None
        while t_first_v1 is None and any(t.is_alive() for t in pending[1]):
            if any(r is not None and r.versions and r.versions[-1] == 1
                   for r in list(eng.rows)):
                t_first_v1 = time.perf_counter() - t_commit0
            else:
                time.sleep(0.0005)
        outs = collect(*pending, "group")
        t_group = time.perf_counter() - tik
        again = client.call("update_weights", {
            "path": snap, "version": 1, "format": "params", "mode": "commit"})
        if again != {"num_interrupted": 0, "version": 1}:
            raise AssertionError(f"{tag}: the repeated commit gave {again}")
        check_outputs(outs, cfg, new_tokens, f"{tag} group")
        splits = []
        for o in outs:
            k = sum(v == 0 for v in o.output_versions)
            if (o.output_versions != [0] * k + [1] * (len(o.output_ids) - k)
                    or o.version_start != 0 or o.version_end != 1):
                raise AssertionError(f"{tag} {o.qid}: versions {o.version_start}"
                                     f"-{o.version_end} {o.output_versions}")
            splits.append(k)
        log(f"{tag}: the commit interrupted {interrupted} rows; the first "
            f"token under v1 came "
            + (f"{t_first_v1:.3f} s after the commit request"
               if t_first_v1 is not None else "in the continuation round")
            + f"; v0 tokens per answer {min(splits)}-{max(splits)} of "
            f"{new_tokens}; the repeated commit was acknowledged ({again}); "
            f"group wall {t_group:.2f} s")

        # 4. continuations under v1, the bad-manifest control
        t_cont0 = time.perf_counter()
        pending = generate_all([list(o.prompt_ids) + list(o.output_ids)
                                for o in outs], cont_new, "group")
        if t_first_v1 is None:
            while t_first_v1 is None and any(t.is_alive() for t in pending[1]):
                if any(r is not None and r.versions and r.versions[-1] == 1
                       for r in list(eng.rows)):
                    t_first_v1 = time.perf_counter() - t_commit0
                else:
                    time.sleep(0.0005)
        conts = collect(*pending, "continuations")
        t_cont = time.perf_counter() - t_cont0
        check_outputs(conts, cfg, cont_new, f"{tag} continuation")
        if any(o.output_versions != [1] * len(o.output_ids) for o in conts):
            raise AssertionError(f"{tag}: a continuation token is not of v1")
        bad = os.path.join(tmp, "bad")
        bad_meta = dict(published_meta, layers=list(published_meta["layers"]))
        layer0 = bad_meta["layers"][0]
        down = layer0["mlp"]["down"]["w"]
        bad_meta["layers"][0] = dict(layer0, mlp=dict(
            layer0["mlp"], down=dict(layer0["mlp"]["down"], w=torch.empty(
                (down.shape[0] + 1, down.shape[1]), dtype=down.dtype,
                device="meta"))))
        checkpoint.write_manifest(bad_meta, bad, version=2)
        stage_s = eng.swap_stage_s
        try:
            client.call("update_weights", {
                "path": bad, "version": 2, "format": "params",
                "mode": "stage"})
            error = ""
        except RuntimeError as e:
            error = str(e)
        (probe,) = collect(*generate_all([prompt], 8, "probe"), "probe")
        log(f"{tag}: bad-manifest control: the stage failed with "
            f"{error[:160]!r}; then serving v{probe.version_end}")
        if (SERVER_BAD_LEAF not in error or "layout" not in error
                or eng.swap_stage_s != stage_s or eng.staged_version is not None
                or probe.output_versions != [1] * len(probe.output_ids)):
            raise AssertionError(f"{tag}: the bad-manifest control: {error!r}")
        launches.check(f"{tag}, group, continuations and probe")
        metrics = client.call("metrics", {})
        log(f"{tag}: metrics: version {metrics['version']}, swaps "
            f"{metrics['swap_swaps_total']} ({metrics['swap_swaps_staged_total']}"
            f" staged), stage {metrics['swap_stage_s']:.3f} s, pause "
            f"{metrics['swap_pause_s']:.3f} s, SLO records "
            f"{metrics['slo']['records_total']}: TTFT p50/p99 "
            f"{metrics['slo']['ttft_s']['p50']}/{metrics['slo']['ttft_s']['p99']}"
            f" s, TPOT p50 {metrics['slo']['tpot_s']['p50']} s, stall p99 "
            f"{metrics['slo']['stall_s']['p99']} s")
        if (metrics["version"] != 1 or metrics["swap_swaps_total"] != 1
                or metrics["swap_swaps_staged_total"] != 1
                or metrics["swap_stage_s"] <= 0
                or metrics["slo"]["records_total"] < 2 * group + 1
                or set(metrics["slo_digests"]) != {
                    "admission_wait_s", "ttft_s", "tpot_s", "stall_s"}):
            raise AssertionError(f"{tag}: metrics {metrics}")
    finally:
        if client is not None:
            client.close()
        if worker is not None:
            worker.exit()
        if thread is not None:
            thread.join(120)
        shutil.rmtree(tmp, ignore_errors=True)
    if thread.is_alive():
        raise AssertionError(f"{tag}: the server did not stop")
    audit_pool(eng, tag)
    del eng, worker
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # logprobs: v0 tokens against the v0 trainer forward, v1 tokens against
    # the trained master's
    mb_spec = MicroBatchSpec(max_tokens_per_mb=mb_tokens or kv_cache_len)

    def gap(what, outs, weights):
        outs = [dataclasses.replace(o, qid=f"{o.qid}/{i}")
                for i, o in enumerate(outs) if o.output_ids]
        trainer = TrainEngine(cfg, None, weights, device=device)
        sample = rollout_sample(outs, SEED)
        g = _response_gap(sample, trainer.forward_batch(
            sample, model_logprobs_fwd(), mb_spec, output_shift=1))
        if not _gap_gate(f"{tag}, {what}", g, TOL_PROX_MEAN, TOL_PROX_MAX,
                         phase="server"):
            raise AssertionError(f"{tag}, {what}: serving and trainer "
                                 "logprobs disagree")
        return g

    def part(o, lo, hi):
        return dataclasses.replace(
            o, prompt_ids=list(o.prompt_ids) + o.output_ids[:lo],
            output_ids=o.output_ids[lo:hi],
            output_logprobs=o.output_logprobs[lo:hi])

    master0 = init_params(cfg, SEED, device, dtype=torch.float32)
    res["gap_v0"] = gap("v0 tokens", [part(o, 0, k)
                                      for o, k in zip(outs, splits)], master0)
    del master0
    res["gap_v1"] = gap("v1 tokens", [part(o, k, len(o.output_ids))
                                      for o, k in zip(outs, splits)]
                        + conts, master)
    secs = time.perf_counter() - t_phase
    res.update(launches=dict(launches.total), publish_s=t_publish,
               stage_s=t_stage, pause_s=t_first_v1, phase_s=secs)
    log(f"{tag}: publish {t_publish:.3f} s, stage {t_stage:.3f} s, pause "
        f"(commit to the first token under v1) "
        + (f"{t_first_v1:.3f} s" if t_first_v1 is not None else "not seen")
        + f", apply window {metrics['swap_pause_s']:.3f} s, phase "
        f"{secs:.1f} s, on {card}")
    if t_first_v1 is None:
        raise AssertionError(f"{tag}: no token under v1 was seen")
    return res


def _by_path(tree, prefix=""):
    """``{path: leaf}`` of a dict/list tree."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _by_path(v, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _by_path(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _bit_equal(a, b) -> bool:
    a, b = _by_path(a), _by_path(b)
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and bool((a[k] == b[k]).all()) for k in a)


def _dir_bytes(path) -> int:
    import os

    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def write_hf_dir(cfg, master, path) -> int:
    """Write ``master`` (the port's tree of a qwen2-like ``cfg``) as a
    ``Qwen2ForCausalLM`` checkpoint directory in bf16: one
    ``model.safetensors`` under transformers' names, written with
    ``safetensors.torch`` directly (not through the port's export), and a
    ``config.json`` like a published Qwen2.5 one (a window with
    ``use_sliding_window: false``, ``rope_scaling: null``).  Returns the
    tensor bytes."""
    import json
    import os

    import torch
    from safetensors.torch import save_file

    def bf16(t):
        return t.detach().to(torch.bfloat16).contiguous().cpu()

    state = {"model.embed_tokens.weight": bf16(master["embed"]["weight"])}
    for i, lp in enumerate(master["layers"]):
        pre = f"model.layers.{i}."
        state[pre + "input_layernorm.weight"] = bf16(lp["attn_norm"]["scale"])
        state[pre + "post_attention_layernorm.weight"] = bf16(
            lp["mlp_norm"]["scale"])
        for x in "qkvo":
            state[f"{pre}self_attn.{x}_proj.weight"] = bf16(
                lp["attn"][x]["w"].T)
        for x in "qkv":
            state[f"{pre}self_attn.{x}_proj.bias"] = bf16(lp["attn"][x]["b"])
        for x in ("gate", "up", "down"):
            state[f"{pre}mlp.{x}_proj.weight"] = bf16(lp["mlp"][x]["w"].T)
    state["model.norm.weight"] = bf16(master["final_norm"]["scale"])
    if not cfg.tied_embedding:
        state["lm_head.weight"] = bf16(master["lm_head"]["w"].T)
    os.makedirs(path, exist_ok=True)
    save_file(state, os.path.join(path, "model.safetensors"),
              metadata={"format": "pt"})
    config = dict(
        architectures=["Qwen2ForCausalLM"], model_type="qwen2",
        hidden_size=cfg.hidden_dim, intermediate_size=cfg.intermediate_dim,
        num_hidden_layers=cfg.n_layers, num_attention_heads=cfg.n_q_heads,
        num_key_value_heads=cfg.n_kv_heads, vocab_size=cfg.vocab_size,
        max_position_embeddings=cfg.max_position_embeddings,
        rms_norm_eps=cfg.norm_eps, rope_theta=cfg.rotary_base,
        rope_scaling=None, tie_word_embeddings=cfg.tied_embedding,
        hidden_act="silu", sliding_window=cfg.max_position_embeddings,
        use_sliding_window=False, max_window_layers=cfg.n_layers,
        attention_dropout=0.0, torch_dtype="bfloat16")
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    return sum(t.numel() * t.element_size() for t in state.values())


def hf_phase(cfg, master, device, card, hf_dir, *, prompt_lens=HF_PROMPT_LENS,
             new_tokens=HF_NEW_TOKENS, max_batch=HF_SERVER_MAX_BATCH,
             kv_cache_len=HF_SERVER_KV_CACHE_LEN, mb_tokens=None,
             **server_kw):
    """HF checkpoint import on the card:

    1. write the seeded weights (``master``) as a bf16 ``Qwen2ForCausalLM``
       directory ``hf_dir`` (:func:`write_hf_dir`);
    2. ``make_model(ModelAbstraction("hf", {"path": hf_dir}))`` for a
       server: the config must equal ``cfg``, the family ``qwen2``, and the
       tree must be bit-identical to ``serving_params`` of the seeded
       weights cast to bf16;
    3. start ``GenerationServerWorker`` (``max_batch`` rows x
       ``kv_cache_len`` tokens) on other random weights (seed ``SEED +
       1``), stage ``hf_dir`` as version 1 with ``format: "hf"`` (the
       staged tree bit-identical to step 2's), pause, commit, resume, and
       serve ``prompt_lens`` (temperature 1, ``new_tokens`` each): every
       token under v1, the served tree bit-identical to step 2's, the paged
       launches against the dispatched work (:class:`LaunchGate`), the
       served logprobs against the trainer forward of ``master``, and the
       leak audit.

    Prints each step's seconds and bytes; ``server_kw`` overrides
    GenServerConfig fields (CPU rehearsals)."""
    import dataclasses
    import threading

    import torch

    from areal_tpu_torch.api.config import ModelAbstraction
    from areal_tpu_torch.api.data import MicroBatchSpec
    from areal_tpu_torch.api.model_api import (
        APIGenerateInput,
        GenerationHyperparameters,
    )
    from areal_tpu_torch.api.system_api import GenServerConfig
    from areal_tpu_torch.base import constants, name_resolve, names
    from areal_tpu_torch.engine.backend import make_model
    from areal_tpu_torch.engine.train_engine import TrainEngine
    from areal_tpu_torch.interfaces.ppo_interface import model_logprobs_fwd
    from areal_tpu_torch.models.convert import serving_params
    from areal_tpu_torch.system.generation_server import (
        GenerationServerWorker,
        GenServerClient,
        parse_server_registration,
    )

    tag = "hf"
    t_phase = time.perf_counter()
    cuda = device.type == "cuda"
    # 1. the directory
    _sync(device)
    tik = time.perf_counter()
    nbytes = write_hf_dir(cfg, master, hf_dir)
    t_write = time.perf_counter() - tik
    log(f"{tag}: wrote a bf16 Qwen2ForCausalLM directory ({nbytes / 1e9:.3f} "
        f"GB in one model.safetensors) in {t_write:.3f} s on {card}")

    # 2. make_model, as a server calls it
    tik = time.perf_counter()
    model = make_model(ModelAbstraction("hf", {"path": hf_dir}), None,
                       device=None if cuda else device)
    _sync(device)
    t_load = time.perf_counter() - tik
    want = serving_params(_tree_map(lambda x: x.to(torch.bfloat16), master),
                          cfg)
    same = (model.model_cfg == cfg and model.backend_name == "qwen2"
            and _bit_equal(model.init_params, want))
    log(f"{tag}: make_model(type_='hf') read {nbytes / 1e9:.3f} GB in "
        f"{t_load:.3f} s: family {model.backend_name}, config equal to the "
        f"seeded one {model.model_cfg == cfg}, tree bit-identical to the "
        f"seeded weights cast to bf16 {same}")
    if not same:
        raise AssertionError(f"{tag}: the loaded model differs")
    del model

    # 3. a server on other weights swaps the directory in, staged
    name_resolve.reconfigure("memory")
    constants.set_experiment_trial_names("chipsmoke", "hf")
    config = GenServerConfig(
        worker_name="gen_server_hf",
        model=ModelAbstraction("random", {"config": cfg, "seed": SEED + 1}),
        max_concurrent_batch=max_batch, kv_cache_len=kv_cache_len,
        device=None if cuda else str(device), **server_kw)
    worker = GenerationServerWorker()
    failed = []

    def run_server():
        try:
            worker.run(config)
        except Exception as e:  # noqa: BLE001 - raised below
            failed.append(e)

    thread = threading.Thread(target=run_server, daemon=True,
                              name="gen-server-hf")
    client = None
    thread.start()
    try:
        key = names.gen_server("chipsmoke", "hf", "gen_server_hf")
        tik = time.perf_counter()
        while True:
            try:
                addr = parse_server_registration(name_resolve.get(key))[0]
                break
            except name_resolve.NameEntryNotFoundError:
                if not thread.is_alive() or time.perf_counter() - tik > 300:
                    raise AssertionError(
                        f"{tag}: the server did not start: {failed}")
                time.sleep(0.01)
        client = GenServerClient(addr, timeout=600)
        eng = worker.engine
        payload = {"path": hf_dir, "version": 1, "format": "hf"}
        tik = time.perf_counter()
        reply = client.call("update_weights", dict(payload, mode="stage"))
        t_stage = time.perf_counter() - tik
        staged_same = (reply.get("staged") == 1 and eng.staged_version == 1
                       and _bit_equal(eng._staged_params, want))
        log(f"{tag}: the server staged the directory as v1 in {t_stage:.3f} "
            f"s request to reply (server {reply.get('stage_seconds')} s); the "
            f"staged tree is bit-identical to the directory's: {staged_same}")
        if not staged_same:
            raise AssertionError(f"{tag}: stage reply {reply}")
        if client.call("pause", {}) != "paused":
            raise AssertionError(f"{tag}: pause")
        client.call("update_weights", dict(payload, mode="commit"))
        if client.call("resume", {}) != "resumed":
            raise AssertionError(f"{tag}: resume")

        prompts = make_prompts(cfg.vocab_size, prompt_lens, SEED + 51)
        launches = LaunchGate(eng, cfg.n_layers, False)
        launches.start()
        outs = [None] * len(prompts)

        def one(i):
            outs[i] = client.generate(APIGenerateInput(
                qid=f"hf-{i}", prompt_ids=prompts[i], input_ids=prompts[i],
                gconfig=GenerationHyperparameters(max_new_tokens=new_tokens)))

        tik = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        t_serve = time.perf_counter() - tik
        if any(o is None for o in outs):
            raise AssertionError(f"{tag}: lost replies: {failed}")
        check_outputs(outs, cfg, new_tokens, tag)
        if any(o.output_versions != [1] * len(o.output_ids) for o in outs):
            raise AssertionError(f"{tag}: a token is not of v1")
        launches.check(f"{tag}, {len(prompts)} requests after the swap")
        served_same = eng.version == 1 and _bit_equal(eng.params, want)
        log(f"{tag}: served {len(prompts)} requests under v1 in {t_serve:.3f} "
            f"s; the served tree is bit-identical to the directory's: "
            f"{served_same}")
        if not served_same:
            raise AssertionError(f"{tag}: the served weights differ")
    finally:
        if client is not None:
            client.close()
        worker.exit()
        thread.join(120)
    if thread.is_alive():
        raise AssertionError(f"{tag}: the server did not stop")
    audit_pool(eng, tag)
    del eng, worker, want
    if cuda:
        torch.cuda.empty_cache()

    # the served logprobs against the trainer forward of the seeded weights
    outs = [dataclasses.replace(o, qid=f"{o.qid}/{i}")
            for i, o in enumerate(outs)]
    sample = rollout_sample(outs, SEED)
    trainer = TrainEngine(cfg, None, master, device=device)
    gap = _response_gap(sample, trainer.forward_batch(
        sample, model_logprobs_fwd(),
        MicroBatchSpec(max_tokens_per_mb=mb_tokens or kv_cache_len),
        output_shift=1))
    del trainer
    if not _gap_gate(f"{tag}, v1 (the directory)", gap, TOL_PROX_MEAN,
                     TOL_PROX_MAX, phase=tag):
        raise AssertionError(f"{tag}: serving and trainer logprobs disagree")
    secs = time.perf_counter() - t_phase
    log(f"{tag}: write {t_write:.3f} s, make_model {t_load:.3f} s, stage "
        f"{t_stage:.3f} s ({nbytes / 1e9:.3f} GB each), phase {secs:.1f} s, "
        f"on {card}")
    return dict(launches=dict(launches.total), bytes=nbytes, write_s=t_write,
                load_s=t_load, stage_s=t_stage, gap=gap, phase_s=secs)


def forced_logprobs(params, cfg, outs):
    """Teacher-forced logprobs of each output's tokens under ``params``
    (any serving tree, an int8 one included: every projection reads its
    weight through ``quantize.leaf_weight``), one row at a time through
    the training forward (the flash kernel on a card): a flat array in
    the order of the outputs' tokens."""
    import numpy as np
    import torch

    from areal_tpu_torch.models.transformer import logprobs_of_labels

    dev = params["embed"]["weight"].device
    out = []
    with torch.no_grad():
        for o in outs:
            seq = list(o.prompt_ids) + list(o.output_ids)
            T = len(seq)
            toks = torch.tensor([seq], dtype=torch.long, device=dev)
            pos = torch.arange(T, device=dev)[None]
            seg = torch.ones((1, T), dtype=torch.int32, device=dev)
            lp = logprobs_of_labels(params, cfg, toks, pos, seg)[0]
            out.append(lp[len(o.prompt_ids) - 1:].float().cpu().numpy())
    return np.concatenate(out)


def _gap(a, b):
    import numpy as np

    d = np.abs(np.asarray(a) - np.asarray(b))
    return float(d.mean()), float(d.max())


def _served(outs):
    import numpy as np

    return np.concatenate([np.asarray(o.output_logprobs, np.float32)
                           for o in outs])


def _stub_server(engine, dtype, stage_chunk_bytes):
    """The generation server's restore path (its format negotiation and its
    staged restore) on ``engine``, without its sockets."""
    import types

    from areal_tpu_torch.base import logging_
    from areal_tpu_torch.system.generation_server import (
        GenerationServerWorker as W,
    )

    stub = type("Stub", (), {
        "_negotiate_weight_format": W._negotiate_weight_format,
        "_load_update_params": W._load_update_params,
    })()
    stub.engine = engine
    stub.config = types.SimpleNamespace(serving_weight_dtype=dtype,
                                        stage_chunk_bytes=stage_chunk_bytes)
    stub.logger = logging_.getLogger("serving_features")
    return stub


def _map_quant_leaves(tree, fn):
    """``tree`` with every int8 projection leaf (``qw``/``scale``) replaced
    by ``fn(leaf)``; the other leaves are shared, not copied."""
    from areal_tpu_torch.models import quantize

    if isinstance(tree, (list, tuple)):
        return [_map_quant_leaves(v, fn) for v in tree]
    if quantize.is_quant_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_quant_leaves(v, fn) for k, v in tree.items()}
    return tree


def _scales_times(tree, factor):
    """An int8 serving tree dequantized at ``factor`` times its scales: a
    mis-scaled dequantization, as a control."""
    return _map_quant_leaves(tree, lambda p: dict(p, scale=p["scale"]
                                                  * factor))


def _host_dequantized(tree, device):
    """The plain version of the card's dequantization at use: every int8
    projection of ``tree`` dequantized by numpy on the host (``qw`` times
    its output channel's scale in float32, then bf16), moved to
    ``device`` as a ``{"w": ...}`` leaf beside its bias."""
    import numpy as np
    import torch

    def deq(p):
        w = (np.asarray(p["qw"].cpu(), np.float32)
             * np.asarray(p["scale"].cpu(), np.float32)[..., None, :])
        out = {k: v for k, v in p.items() if k not in ("qw", "scale")}
        out["w"] = torch.from_numpy(w).to(torch.bfloat16).to(device)
        return out

    return _map_quant_leaves(tree, deq)


def publish_snapshot(master, path, version):
    """Publish ``master`` as the loop's model worker does: the tree cast to
    bf16, its int8 sibling tree, and a manifest advertising both.
    Returns (seconds, bytes written)."""
    import os

    import torch

    from areal_tpu_torch.engine import checkpoint

    tik = time.perf_counter()
    checkpoint.save_params(master, path, cast_dtype=torch.bfloat16)
    qpath = checkpoint.quant_snapshot_path(path)
    qavals = checkpoint.save_quantized_params(
        master, qpath, cast_dtype=torch.bfloat16)
    meta = _tree_map(lambda t: torch.empty(tuple(t.shape), dtype=torch.bfloat16,
                                           device="meta"), master)
    checkpoint.write_manifest(meta, path, version=version, serving_quant={
        "int8": checkpoint.quant_manifest_entry(qavals, qpath)})
    return time.perf_counter() - tik, _dir_bytes(path) + _dir_bytes(qpath)


def mistral_config(n_layers):
    """Mistral-7B-v0.1's published configuration (hidden 4096, 32 query
    and 8 KV heads, MLP 14336, vocabulary 32000, a sliding window of 4096,
    RoPE base 10000) as ``transformers`` builds it, through the port's HF
    registry, cut to ``n_layers`` layers, in bf16."""
    import dataclasses

    import transformers

    from areal_tpu_torch.models.hf.registry import family_from_architecture

    hf = transformers.MistralConfig(
        hidden_size=4096, intermediate_size=14336, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=8, vocab_size=32000,
        sliding_window=4096, rope_theta=10000.0, rms_norm_eps=1e-5,
        max_position_embeddings=32768, tie_word_embeddings=False,
    ).to_dict()
    hf["architectures"] = ["MistralForCausalLM"]
    cfg = family_from_architecture("MistralForCausalLM").config_from_hf(hf)
    return dataclasses.replace(cfg, n_layers=n_layers, dtype="bfloat16")


def gemma_config(n_layers):
    """Gemma-2B's published configuration (``google/gemma-2b``
    ``config.json``: hidden 2048, MLP 16384, 8 query heads and 1 KV head
    of 256, vocabulary 256000, gelu, tied embeddings, RMSNorm eps 1e-6,
    RoPE base 10000, 18 layers) as ``transformers`` builds it, through the
    port's HF registry, cut to ``n_layers`` layers, in bf16."""
    import dataclasses

    import transformers

    from areal_tpu_torch.models.hf.registry import family_from_architecture

    hf = transformers.GemmaConfig(
        hidden_size=2048, intermediate_size=16384, num_hidden_layers=18,
        num_attention_heads=8, num_key_value_heads=1, head_dim=256,
        vocab_size=256000, hidden_act="gelu", rms_norm_eps=1e-6,
        rope_theta=10000.0, max_position_embeddings=8192,
        tie_word_embeddings=True,
    ).to_dict()
    hf["architectures"] = ["GemmaForCausalLM"]
    cfg = family_from_architecture("GemmaForCausalLM").config_from_hf(hf)
    return dataclasses.replace(cfg, n_layers=n_layers, dtype="bfloat16")


def serving_features_phase(
    cfg, master, device, card, *, prompt_lens=FEAT_PROMPT_LENS,
    new_tokens=FEAT_NEW_TOKENS, max_batch=MAX_BATCH,
    kv_cache_len=KV_CACHE_LEN, page_size=PAGE_SIZE,
    prefill_chunk=PREFILL_CHUNK, chunk_size=CHUNK_SIZE,
    max_draft=SPEC_MAX_DRAFT, spill_prompt=SPILL_PROMPT,
    spill_new=SPILL_NEW_TOKENS, spill_pool_blocks=SPILL_POOL_BLOCKS,
    dense_kv=DENSE_KV_CACHE_LEN, dense_lens=DENSE_PROMPT_LENS,
    dense_new=DENSE_NEW_TOKENS, mistral_cfg=None,
    mistral_prompt=MISTRAL_PROMPT, mistral_kv=MISTRAL_KV_CACHE_LEN,
    mistral_new=MISTRAL_NEW_TOKENS, stage_chunk_bytes=256 << 20,
    w8_tol=(TOL_W8_MEAN, TOL_W8_MAX), prox_tol=(TOL_PROX_MEAN, TOL_PROX_MAX),
    int8_tol=(TOL_INT8_MEAN, TOL_INT8_MAX),
    window_tol=(TOL_WINDOW_MEAN, TOL_WINDOW_MAX)):
    """The engine's serving features (``cfg`` and ``master``: the 14-layer
    copy of the HF directory, loaded as float32 master weights):

    A. int8 serving weights: the card's ``quantize_weight`` bit for bit
       with the CPU's on every matrix; an int8 engine's greedy wave
       against a bf16 engine's (resident bytes, decode tokens/s, the
       teacher-forced logprob gap on the bf16 engine's tokens with a
       mis-scaled control, its own served logprobs against the int8
       forward); the int8 forward bit for bit with the forward over the
       weights numpy dequantized on the host, and a one-step mis-scaled
       control; an int8 wave on an int8 pool; staged swaps from a
       published int8 sibling tree and from a full tree (quantized on
       arrival), each staged tree bit-equal to the engine's own
       quantization of the published weights.
    B. speculative decoding: a float32 arm whose spec-on tokens (drafting
       by itself, then set drafts all correct, then wrong at their first
       token) equal spec-off's (float32 q runs the paged kernel's decode
       entry, verify windows included); a bf16 arm, whose verify windows
       run the tensor-core prefill entry, with its served logprobs held
       against the forward and its first divergence from spec off
       reported with the logit margin there; every arm's launches
       against the dispatched fills, decode chunks and verify windows;
       the card's verify cost in decode steps.
    C. the prefix cache's host tier: a group spilled under a small bf16
       pool and restored, tokens equal to an arm whose pool keeps it; the
       leak audit (an int8 pool's spill is held on the CPU only).
    D. the dense cache: Qwen at a 2048-token cache against the paged
       engine on the same prompts, ``flash_decode`` launches against the
       dispatched decode steps; the Mistral-7B-v0.1 configuration at full
       width (``mistral_cfg``, random weights) with a prompt past its
       window, on the window-gather path, against the windowed forward
       (the prefill's flash kernel with the window)."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    from areal_tpu_torch.engine import checkpoint
    from areal_tpu_torch.engine.sampling import SamplingParams
    from areal_tpu_torch.engine.spec_decode import (
        SpecDecodeParams,
        SpecRowState,
    )
    from areal_tpu_torch.models import quantize
    from areal_tpu_torch.models.convert import serving_params
    from areal_tpu_torch.models.transformer import (
        KVCache,
        init_params,
        prefill,
    )
    from areal_tpu_torch.ops import decode_attention as tda
    from areal_tpu_torch.ops import flash_attention as tfa
    from areal_tpu_torch.ops import paged_attention as tpa

    L = cfg.n_layers
    greedy = SamplingParams(greedy=True)
    res = dict(launches=dict(
        fp=dict(std=0, deep=0, prefill=0, verify=0),
        int8=dict(std=0, deep=0, prefill=0, verify=0),
        flash_decode=0, flash_fwd=0))
    t_phase = time.perf_counter()
    params = serving_params(master, cfg)
    prompts = make_prompts(cfg.vocab_size, prompt_lens, SEED + 71)
    engine_kw = dict(max_batch=max_batch, kv_cache_len=kv_cache_len,
                     page_size=page_size, prefill_chunk_tokens=prefill_chunk,
                     chunk_size=chunk_size)

    def gated_wave(eng, reqs, what, int8_pool=False, tensor_cores=True):
        gate = LaunchGate(eng, L, int8_pool, tensor_cores=tensor_cores)
        gate.start()
        outs, secs = serve(eng, reqs)
        gate.check(what)
        bucket = res["launches"]["int8" if int8_pool else "fp"]
        for k, v in gate.total.items():
            bucket[k] += v
        return outs, secs

    def decode_tps(outs, secs):
        return sum(len(o.output_ids) for o in outs) / secs

    # -- A. int8 serving weights --------------------------------------------
    tik = time.perf_counter()
    n_mat = 0
    for lp in params["layers"]:
        for blk, names in (("attn", "qkvo"), ("mlp", ("gate", "up", "down"))):
            for n in names:
                w = lp[blk][n]["w"]
                qd, sd = quantize.quantize_weight(w)
                # the CPU quantizes the same values, widened on the card
                # (a bf16 weight widens to float32 exactly)
                qc, sc = quantize.quantize_weight(w.float().cpu())
                nq = int((qd.cpu() != qc).sum())
                ns = int((sd.cpu().view(torch.int32)
                          != sc.view(torch.int32)).sum())
                if nq or ns:
                    raise AssertionError(
                        f"quantize_weight on the card differs from the CPU's "
                        f"({blk}/{n} {tuple(w.shape)}: {nq} int8 values, "
                        f"{ns} scales)")
                n_mat += 1
    log(f"features: quantize_weight on the card is bit-identical to the "
        f"CPU's on all {n_mat} matrices of the {L} layers (bf16 weights, int8 "
        f"values and float32 scales) ({time.perf_counter() - tik:.1f} s)")

    bf = build_engine(cfg, params, device, greedy, **engine_kw)
    q8 = build_engine(cfg, params, device, greedy,
                      serving_weight_dtype="int8", **engine_kw)
    for eng in (bf, q8):  # warm-up, not timed
        serve(eng, requests([p[:64] for p in prompts[:2]], 4, "warm"))
    reqs = requests(prompts, new_tokens, "feat")
    bf_outs, bf_secs = gated_wave(bf, reqs, "features, bf16 weights")
    q8_outs, q8_secs = gated_wave(q8, reqs, "features, int8 weights")
    check_outputs(q8_outs, cfg, new_tokens, "int8 weights")
    wb, wq = bf.weight_quant_stats(), q8.weight_quant_stats()
    if not (wq["quantized"] and wq["storage_bits"] == 8
            and not wb["quantized"]):
        raise AssertionError(f"weight formats: bf16 {wb}, int8 {wq}")
    lp_bf = forced_logprobs(bf.params, cfg, bf_outs)
    lp_q8_on_bf = forced_logprobs(q8.params, cfg, bf_outs)
    gap_w8 = _gap(lp_q8_on_bf, lp_bf)
    # the card's dequantization at use against numpy's on the host: the
    # same forward over both trees, bit for bit; the controls (scales one
    # step, and a quarter, too large) must fail their gates
    lp_host = forced_logprobs(_host_dequantized(q8.params, device), cfg,
                              bf_outs)
    gap_deq = _gap(lp_q8_on_bf, lp_host)
    gap_deq_ctrl = _gap(forced_logprobs(
        _scales_times(q8.params, W8_STEP_CONTROL), cfg, bf_outs), lp_host)
    gap_w8_ctrl = _gap(forced_logprobs(
        _scales_times(q8.params, W8_DRIFT_CONTROL), cfg, bf_outs), lp_bf)
    del lp_host
    gap_q8 = _gap(_served(q8_outs), forced_logprobs(q8.params, cfg, q8_outs))
    gap_bf = _gap(_served(bf_outs), lp_bf)
    agree, first = zip(*(_first_divergence(a.output_ids, b.output_ids)
                         for a, b in zip(q8_outs, bf_outs)))
    res["int8"] = dict(
        bf16_bytes=wb["param_bytes"], int8_bytes=wq["param_bytes"],
        ratio=wb["param_bytes"] / wq["param_bytes"],
        bf16_tps=decode_tps(bf_outs, bf_secs),
        int8_tps=decode_tps(q8_outs, q8_secs), gap_w8=gap_w8,
        gap_w8_control=gap_w8_ctrl, gap_dequant=gap_deq,
        gap_dequant_control=gap_deq_ctrl,
        agree=sum(agree), tokens=sum(len(o.output_ids) for o in bf_outs))
    log(f"features, int8 weights on {card}: resident weights "
        f"{wb['param_bytes']} B bf16, {wq['param_bytes']} B int8 "
        f"({res['int8']['ratio']:.3f}x smaller; {wq['quantized_leaves']} "
        f"projections a layer stack, the tied embedding stays bf16); a wave "
        f"of {len(reqs)} x {new_tokens} tokens: bf16 {bf_secs:.2f} s "
        f"({res['int8']['bf16_tps']:.1f} tok/s), int8 {q8_secs:.2f} s "
        f"({res['int8']['int8_tps']:.1f} tok/s, wall incl. prefill); "
        f"greedy tokens agree {sum(agree)}/{res['int8']['tokens']} (first "
        f"divergences {list(first)})")
    if not _gap_gate("int8 weights: teacher-forced logprobs of the bf16 "
                     "engine's tokens, int8 against bf16", gap_w8, *w8_tol,
                     phase="features"):
        raise AssertionError("int8 serving weights drift past their limit")
    if _gap_gate(f"control: the int8 scales x {W8_DRIFT_CONTROL} against "
                 "bf16, which must fail", gap_w8_ctrl, *w8_tol,
                 phase="features"):
        raise AssertionError("the int8 drift gate cannot see a mis-scale")
    if not _gap_gate("int8 weights: the card's dequantization at use "
                     "against numpy's on the host, bit for bit", gap_deq,
                     0.0, 0.0, phase="features"):
        raise AssertionError("the card's dequantization differs from the "
                             "host's")
    if _gap_gate(f"control: the int8 scales x {W8_STEP_CONTROL:.6f} (one "
                 "step) against the host's dequantization, which must fail",
                 gap_deq_ctrl, 0.0, 0.0, phase="features"):
        raise AssertionError("the dequantization gate cannot see a one-step "
                             "mis-scale")
    for what, gap in (("int8 engine served against its forward", gap_q8),
                      ("bf16 engine served against its forward", gap_bf)):
        if not _gap_gate(what, gap, *prox_tol, phase="features"):
            raise AssertionError(f"{what}: logprobs disagree")
    q8.note_weight_divergence_check(res["int8"]["tokens"],
                                    res["int8"]["tokens"] - sum(agree))
    audit_pool(bf, "features, bf16 weights")
    del bf
    # int8 weights over an int8 pool
    q8k = build_engine(cfg, params, device, greedy,
                       serving_weight_dtype="int8", kv_cache_dtype="int8",
                       **engine_kw)
    outs, _ = gated_wave(q8k, requests(prompts, 16, "feat-kv8"),
                         "features, int8 weights over an int8 pool",
                         int8_pool=True)
    gap = _gap(_served(outs), forced_logprobs(q8k.params, cfg, outs))
    if not _gap_gate("int8 weights over an int8 pool, served against the "
                     "int8 forward", gap, *int8_tol, phase="features"):
        raise AssertionError("int8 weights over an int8 pool disagree")
    audit_pool(q8k, "features, int8 weights over an int8 pool")
    del q8k

    # staged swaps: from the published int8 sibling tree and from a full
    # tree, each staged while a wave decodes
    root = tempfile.mkdtemp(prefix="chip_smoke_w8_")
    try:
        w1 = _perturbed(master, SEED + 55)
        want = q8._serving_copy(_tree_map(lambda t: t.to(torch.bfloat16), w1))
        srv = _stub_server(q8, "int8", stage_chunk_bytes)
        swaps = {}
        for version, with_int8 in ((1, True), (2, False)):
            snap = os.path.join(root, f"v{version}")
            if with_int8:
                pub_s, pub_b = publish_snapshot(w1, snap, version)
            else:
                # the same full tree under a manifest that advertises no
                # int8 tree (a publisher without it), its tensors linked
                os.makedirs(snap)
                os.symlink(os.path.join(root, "v1", checkpoint.TENSORS_NAME),
                           os.path.join(snap, checkpoint.TENSORS_NAME))
                manifest = checkpoint.read_manifest(os.path.join(root, "v1"))
                manifest.pop("serving_quant")
                with open(os.path.join(snap, checkpoint.MANIFEST_NAME),
                          "w") as f:
                    json.dump(manifest, f)
                pub_s, pub_b = 0.0, 0
            for r in requests(prompts, 16, f"swap{version}"):
                q8.submit(r)
            for _ in range(3):
                q8.step()  # rows decoding while the tree stages
            fmt, rpath, _ = srv._negotiate_weight_format(
                snap, checkpoint.read_manifest(snap))
            tik = time.perf_counter()
            staged = srv._load_update_params(
                dict(path=snap, format="params", version=version), True)
            q8.stage_weights(staged, version, owned=True)
            stage_s = time.perf_counter() - tik
            same = all(a.dtype == b.dtype and torch.equal(a, b)
                       for a, b in zip(_leaves(staged), _leaves(want)))
            p0 = q8.swap_pause_s
            q8.commit_staged(expected_version=version)
            q8.step()  # the apply
            pause_s = q8.swap_pause_s - p0
            while q8.has_work:
                q8.step()
            q8.drain_results()
            swaps[fmt] = dict(publish_s=pub_s, publish_bytes=pub_b,
                              stage_s=stage_s, commit_s=pause_s,
                              restored_bytes=_dir_bytes(rpath),
                              bit_equal=same)
            published = (f"published in {pub_s:.2f} s ({pub_b} B with the "
                         f"int8 tree)" if with_int8 else
                         "v1's tensors under a manifest without the int8 tree")
            log(f"features, int8 engine, staged swap to v{version} from the "
                f"{fmt} tree ({os.path.basename(rpath)}, "
                f"{_dir_bytes(rpath)} B read; {published}): stage "
                f"{stage_s:.2f} s while 16-token "
                f"rows decode, commit (the apply: ring drain, flip, cache "
                f"flush, recompute) {pause_s:.3f} s; staged tree bit-equal "
                f"to the engine's quantization of the published weights: "
                f"{same}")
            if not same or q8.version != version:
                raise AssertionError(f"staged swap from the {fmt} tree")
        if set(swaps) != {"int8", "full"}:
            raise AssertionError(f"negotiated formats {sorted(swaps)}")
        outs, _ = serve(q8, requests(prompts[:4], 16, "after-swap"))
        gap = _gap(_served(outs), forced_logprobs(q8.params, cfg, outs))
        if not _gap_gate("int8 engine after the swaps, served against the "
                         "forward of the swapped-in weights", gap,
                         *prox_tol, phase="features"):
            raise AssertionError("int8 engine after the swaps disagrees")
        res["swap"] = swaps
    finally:
        shutil.rmtree(root, ignore_errors=True)
    audit_pool(q8, "features, int8 weights")
    del q8
    log(f"features: int8 weights done at {time.perf_counter() - t_phase:.1f} s")
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # -- B. speculative decoding --------------------------------------------
    spec_res = {}

    def forced_drafts(refs, mutate):
        def draft(self, history, sp):
            for prompt, ref in refs.items():
                if tuple(history[: len(prompt)]) == prompt:
                    pos = len(history) - len(prompt)
                    return mutate(list(ref[pos: pos + sp.max_draft_tokens]))
            return []
        return draft

    real_draft = SpecRowState.draft
    spec = SpecDecodeParams(enabled=True, max_draft_tokens=max_draft)
    for dtype in ("float32", "bfloat16"):
        scfg = dataclasses.replace(cfg, dtype=dtype)
        sparams = params if dtype == "bfloat16" else serving_params(master,
                                                                    scfg)
        tc = dtype == "bfloat16"
        if tc:
            # section A's bf16 engine served these requests spec off
            ref, off_s = bf_outs, bf_secs
        else:
            off = build_engine(scfg, sparams, device, greedy, **engine_kw)
            ref, off_s = gated_wave(off, requests(prompts, new_tokens,
                                                  "spec"),
                                    f"spec {dtype}, spec off",
                                    tensor_cores=tc)
            audit_pool(off, f"spec {dtype}, spec off")
            del off
        refs = {tuple(p): o.output_ids for p, o in zip(prompts, ref)}
        arms = (("drafting", None), ("all correct", lambda c: c),
                ("wrong first", lambda c: [(t + 1) % cfg.vocab_size
                                           for t in c]))
        if dtype == "bfloat16":
            arms = arms[:2]  # the float32 arm holds the rejections exact
        for arm, mutate in arms:
            SpecRowState.draft = (real_draft if mutate is None
                                  else forced_drafts(refs, mutate))
            try:
                eng = build_engine(scfg, sparams, device, greedy,
                                   spec_decode_params=spec, **engine_kw)
                outs, secs = gated_wave(
                    eng, requests(prompts, new_tokens, "spec"),
                    f"spec {dtype}, {arm}", tensor_cores=tc)
            finally:
                SpecRowState.draft = real_draft
            st = eng.spec_stats()
            same, firsts = zip(*(_first_divergence(a.output_ids, b.output_ids)
                                 for a, b in zip(outs, ref)))
            n_tok = sum(len(o.output_ids) for o in ref)
            ok = all(f is None for f in firsts)
            v = max(st["verify_chunks_total"], 1)
            log(f"spec {dtype}, {arm}: {st['verify_chunks_total']} verify "
                f"windows ({st['draft_row_passes_total']} row passes), "
                f"{st['drafted_total']} drafted, {st['accepted_total']} "
                f"accepted ({st['accepted_total'] / v:.2f} a window), "
                f"{st['fallback_rows_total']} rows fell back; {secs:.2f} s "
                f"against {off_s:.2f} s spec off; tokens equal to spec off "
                f"{sum(same)}/{n_tok}")
            entry = dict(stats=st, secs=secs, off_secs=off_s, agree=sum(same),
                         tokens=n_tok)
            if tc:
                # the verify windows' logprobs, from the prefill entry,
                # against the training forward on the same tokens
                gap = _gap(_served(outs), forced_logprobs(sparams, scfg, outs))
                entry["gap"] = gap
                if not _gap_gate(f"spec {dtype}, {arm}, served against the "
                                 "forward", gap, *prox_tol, phase="features"):
                    raise AssertionError(f"spec {dtype}, {arm}: logprobs "
                                         "disagree")
            if dtype == "float32":
                if not ok:
                    raise AssertionError(
                        f"spec float32, {arm}: tokens differ from spec off "
                        f"(first divergences {list(firsts)})")
                if mutate is not None and st["verify_chunks_total"] == 0:
                    raise AssertionError(f"spec float32, {arm}: no verify")
                if arm == "all correct" and st["accepted_total"] < (
                        0.7 * st["drafted_total"]):
                    raise AssertionError(f"spec float32, {arm}: {st}")
                if arm == "wrong first" and (st["accepted_total"]
                                             or not st["rejected_total"]):
                    raise AssertionError(f"spec float32, {arm}: {st}")
            elif not ok:
                # where the two attention entries part at a near-tie: the
                # top two logits of the spec-off stream there
                i = next(j for j, f in enumerate(firsts) if f is not None)
                o, f = ref[i], firsts[i]
                seq = list(o.prompt_ids) + list(o.output_ids[:f])
                with torch.no_grad():
                    T = len(seq)
                    x = torch.tensor([seq], device=device)
                    cache = KVCache.zeros(scfg, 1, T, device)
                    logits, _ = prefill(
                        sparams, scfg, x, torch.arange(T, device=device)[None],
                        torch.ones((1, T), dtype=torch.int32, device=device),
                        cache, last_pos=torch.tensor([T - 1], device=device))
                top = torch.topk(logits[0, 0].float(), 2).values.tolist()
                entry.update(first_row=i, first_at=f,
                             margin=top[0] - top[1])
                log(f"spec bf16, {arm}: first divergence in row {i} at "
                    f"token {f}; the spec-off stream's top two logits there "
                    f"{top[0]:.4f} / {top[1]:.4f} (margin "
                    f"{top[0] - top[1]:.4f})")
            spec_res[(dtype, arm)] = entry
            audit_pool(eng, f"spec {dtype}, {arm}")
            del eng
        del sparams
        if device.type == "cuda":
            torch.cuda.empty_cache()
    # the verify pass's cost in plain decode steps, bf16, 8 live rows
    eng = build_engine(cfg, params, device, greedy, spec_decode_params=spec,
                       **engine_kw)
    cost_reqs = requests(prompts, kv_cache_len, "cost")  # budgets capped
    for r in cost_reqs:
        eng.submit(r)
    for _ in range(10000):
        if (eng.n_decoding == len(prompts) and not eng._filling
                and not eng.n_pending):
            break
        eng.step()
    else:
        raise AssertionError("spec cost: the rows never all decoded")
    eng._drain_ring()
    live = [i for i, r in enumerate(eng.rows) if r is not None]
    t_dec, t_ver = [], []
    for _ in range(3):
        for kind in ("decode", "verify"):
            _sync(device)
            tik = time.perf_counter()
            if kind == "decode":
                eng._dispatch_chunk_paged()
            else:
                eng._dispatch_verify_chunk(
                    live, {i: [eng.rows[i].cur_token] * max_draft
                           for i in live})
            eng._drain_ring()
            _sync(device)
            (t_dec if kind == "decode" else t_ver).append(
                time.perf_counter() - tik)
    step_s = float(np.median(t_dec)) / chunk_size
    cost = float(np.median(t_ver)) / step_s
    spec_res["cost"] = dict(verify_s=float(np.median(t_ver)), step_s=step_s,
                            cost=cost)
    log(f"spec on {card}: a verify window of {max_draft + 1} over "
        f"{len(live)} rows takes {np.median(t_ver) * 1e3:.2f} ms, a decode "
        f"step {step_s * 1e3:.2f} ms (a {chunk_size}-step chunk over "
        f"{chunk_size}): verify_cost_over_decode_step {cost:.3f} (the "
        f"default, set on a TPU, is "
        f"{SpecDecodeParams().verify_cost_over_decode_step})")
    for r in cost_reqs:
        eng.cancel(r.qid)
    eng.drain_results()
    audit_pool(eng, "spec, verify cost")
    del eng
    res["spec"] = spec_res
    log(f"features: speculative decoding done at "
        f"{time.perf_counter() - t_phase:.1f} s")

    # -- C. the prefix cache's host tier (a bf16 pool; the int8 pool's
    # spill is held on the CPU) -----------------------------------------------
    spill_res = {}
    group_a = make_prompts(cfg.vocab_size, (spill_prompt,) * max_batch,
                           SEED + 81)
    group_b = make_prompts(cfg.vocab_size, (spill_prompt,) * max_batch,
                           SEED + 82)
    outs_by_arm = {}
    for arm in ("host tier", "no spill"):
        kw = dict(engine_kw, prefix_cache=True)
        if arm == "host tier":
            kw.update(kv_pool_tokens=spill_pool_blocks * page_size,
                      prefix_cache_host_bytes=4 << 30)
        else:
            kw.update(prefix_cache_capacity_frac=1.0)
        eng = build_engine(cfg, params, device, greedy, **kw)
        eng.park_ttl_steps = 0
        for tag, group in (("a", group_a), ("b", group_b)):
            serve(eng, requests(group, spill_new, f"spill-{tag}"))
        # group A again, one request at a time: the fills and decode steps
        # then have the same shapes in both arms, so their products round
        # alike and the tokens can be held equal
        p0 = eng.prefill_tokens_total
        gate = LaunchGate(eng, L, False)
        gate.start()
        outs, secs = [], 0.0
        for r in requests(group_a, spill_new, "spill-again"):
            (o,), dt = serve(eng, [r])
            outs.append(o)
            secs += dt
        gate.check(f"host tier, {arm}, group A again")
        for k, v in gate.total.items():
            res["launches"]["fp"][k] += v
        st = eng.prefix_cache_stats()
        prefilled = eng.prefill_tokens_total - p0
        outs_by_arm[arm] = outs
        spill_res[arm] = dict(
            prefilled=prefilled,
            saved=len(group_a) * spill_prompt - prefilled,
            spilled=st["spilled_blocks_total"],
            restored=st["restored_blocks_total"],
            spill_bytes=eng.host_spill_bytes_total,
            restore_bytes=eng.host_restore_bytes_total,
            restore_s=eng.host_restore_seconds_total, secs=secs)
        log(f"host tier, {arm} ({eng.n_blocks} blocks, the cache's capacity "
            f"{st['capacity_blocks']}): group A again prefilled {prefilled} "
            f"of {len(group_a) * spill_prompt} prompt tokens; "
            f"{st['spilled_blocks_total']} blocks spilled "
            f"({eng.host_spill_bytes_total} B in "
            f"{eng.host_spill_rounds_total} rounds), "
            f"{st['restored_blocks_total']} restored "
            f"({eng.host_restore_bytes_total} B in "
            f"{eng.host_restore_rounds_total} rounds, "
            f"{eng.host_restore_seconds_total * 1e3:.1f} ms on the host), "
            f"{st['host_dropped_blocks_total']} dropped")
        if arm == "host tier" and not (st["spilled_blocks_total"]
                                       and st["restored_blocks_total"]):
            raise AssertionError(f"host tier: nothing spilled or restored: "
                                 f"{st}")
        audit_pool(eng, f"host tier, {arm}")
        del eng
    same, firsts = zip(*(_first_divergence(a.output_ids, b.output_ids)
                         for a, b in zip(outs_by_arm["host tier"],
                                         outs_by_arm["no spill"])))
    if any(f is not None for f in firsts) or (
            spill_res["host tier"]["prefilled"]
            != spill_res["no spill"]["prefilled"]):
        raise AssertionError(
            f"host tier: the restored group's tokens differ from the arm "
            f"that kept it (first divergences {list(firsts)})")
    log(f"host tier: the spilled and restored group's tokens equal those of "
        f"the arm whose pool kept it ({sum(same)} tokens)")
    # one synchronous round trip of 16 blocks, timed
    eng = build_engine(cfg, params, device, greedy, **engine_kw)
    blocks = list(range(16))
    _sync(device)
    tik = time.perf_counter()
    host = eng._spill_gather(blocks)
    gather_s = time.perf_counter() - tik
    tik = time.perf_counter()
    eng._scatter_host_payloads(
        [tuple(a[i] for a in host) for i in range(16)], list(range(16, 32)))
    _sync(device)
    restore_s = time.perf_counter() - tik
    nbytes = sum(a.numel() * a.element_size() for a in host)
    spill_res["round_trip"] = dict(blocks=16, bytes=nbytes, gather_s=gather_s,
                                   restore_s=restore_s)
    log(f"host tier on {card}: 16 blocks ({nbytes} B) gathered to pinned host "
        f"memory in {gather_s * 1e3:.2f} ms, restored in "
        f"{restore_s * 1e3:.2f} ms (synchronised)")
    del eng, host
    res["spill"] = spill_res
    log(f"features: host tier done at {time.perf_counter() - t_phase:.1f} s")

    # -- D. the dense cache -------------------------------------------------
    dprompts = make_prompts(cfg.vocab_size, dense_lens, SEED + 91)
    dres = {}
    for mode in ("paged", "dense"):
        eng = build_engine(cfg, params, device, greedy,
                           **dict(engine_kw, cache_mode=mode,
                                  kv_cache_len=dense_kv))
        serve(eng, requests([p[:64] for p in dprompts[:2]], 4, "warm"))
        if mode == "paged":
            outs, secs = gated_wave(eng, requests(dprompts, dense_new, "dn"),
                                    "dense comparison, paged engine")
        else:
            tda.flash_decode.launches = 0
            tfa.flash_attention.fwd_launches = 0
            p0 = tpa.paged_flash_attention.launches
            c0, f0 = eng.decode_chunks_total, eng.prefill_calls
            outs, secs = serve(eng, requests(dprompts, dense_new, "dn"))
            chunks = eng.decode_chunks_total - c0
            fills = eng.prefill_calls - f0
            got = (tda.flash_decode.launches,
                   tfa.flash_attention.fwd_launches)
            # an admission's prompts prefill an empty cache: the flash
            # kernel on a card (the CPU's plain path is the masked product)
            want = (L * chunk_size * chunks,
                    L * fills if device.type == "cuda" else 0)
            log(f"dense engine ({dense_kv}-token cache): {fills} batched "
                f"prefills, {chunks} decode chunks; flash_decode launches "
                f"{got[0]} (expected {want[0]}), flash forward {got[1]} "
                f"(expected {want[1]})")
            if got != want or tpa.paged_flash_attention.launches != p0:
                raise AssertionError(f"dense engine launches {got} against "
                                     f"the dispatched work {want}")
            res["launches"]["flash_decode"] += got[0]
            res["launches"]["flash_fwd"] += got[1]
        check_outputs(outs, cfg, dense_new, f"dense comparison, {mode}")
        gap = _gap(_served(outs), forced_logprobs(eng.params, cfg, outs))
        if not _gap_gate(f"{mode} engine at a {dense_kv}-token cache, served "
                         "against the forward", gap, *prox_tol, phase="features"):
            raise AssertionError(f"{mode} engine logprobs disagree")
        dres[mode] = dict(outs=outs, secs=secs, tps=decode_tps(outs, secs))
        if mode == "paged":
            audit_pool(eng, "dense comparison, paged engine")
        elif eng.close() != {} or eng.preempted_total != 0:
            raise AssertionError("dense engine audit")
        del eng
    same, firsts = zip(*(_first_divergence(a.output_ids, b.output_ids)
                         for a, b in zip(dres["dense"]["outs"],
                                         dres["paged"]["outs"])))
    log(f"dense against paged on {card}, {len(dprompts)} prompts "
        f"{list(dense_lens)} x {dense_new} new tokens: dense "
        f"{dres['dense']['secs']:.2f} s ({dres['dense']['tps']:.1f} tok/s), "
        f"paged {dres['paged']['secs']:.2f} s ({dres['paged']['tps']:.1f} "
        f"tok/s), walls with the prefill; tokens agree "
        f"{sum(same)}/{sum(len(o.output_ids) for o in dres['paged']['outs'])}")
    res["dense"] = {k: dict(secs=v["secs"], tps=v["tps"])
                    for k, v in dres.items()}
    log(f"features: dense Qwen done at {time.perf_counter() - t_phase:.1f} s")
    del params
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the sliding-window model through the dense cache
    mcfg = mistral_cfg or mistral_config(MISTRAL_LAYERS)
    tik = time.perf_counter()
    mparams = init_params(mcfg, SEED, device)
    n_m = sum(t.numel() for t in _leaves(mparams))
    eng = build_engine(mcfg, mparams, device, greedy, cache_mode="auto",
                       max_batch=1, kv_cache_len=mistral_kv,
                       chunk_size=chunk_size)
    if eng.paged:
        raise AssertionError("a sliding-window model resolved to the pool")
    (mprompt,) = make_prompts(mcfg.vocab_size, (mistral_prompt,), SEED + 93)
    tda.flash_decode.launches = 0
    c0 = eng.decode_chunks_total
    # each chunk's attn_len, read while the row is live: the gather reads
    # the window rounded up to 128, capped at attn_len
    attn_lens, bucket = [], eng._attn_bucket

    def recorded_bucket(extra=0):
        attn_lens.append(bucket(extra))
        return attn_lens[-1]

    eng._attn_bucket = recorded_bucket
    (mo,), msecs = serve(eng, requests([mprompt], mistral_new, "mistral"))
    chunks = eng.decode_chunks_total - c0
    fd = tda.flash_decode.launches
    Ww = sorted({min(-(-min(mcfg.sliding_window, a) // 128) * 128, a)
                 for a in attn_lens})
    log(f"features, {mcfg.n_layers}-layer Mistral-7B-v0.1 configuration "
        f"({n_m / 1e9:.3f} B parameters, random, window "
        f"{mcfg.sliding_window}), a {mistral_prompt}-token prompt, "
        f"{len(mo.output_ids)} new tokens in {msecs:.2f} s; {chunks} decode "
        f"chunks (attn_len {sorted(set(attn_lens))}) read each row's last "
        f"{Ww} cache slots (window gather); "
        f"flash_decode launches {fd} (expected "
        f"{mcfg.n_layers * chunk_size * chunks})")
    if fd != mcfg.n_layers * chunk_size * chunks or fd == 0:
        raise AssertionError("the window-gather path's flash_decode launches")
    res["launches"]["flash_decode"] += fd
    check_outputs([mo], mcfg, mistral_new, "mistral")

    def plain_logprobs(c):
        seq = list(mo.prompt_ids) + list(mo.output_ids)
        T = len(seq)
        with torch.no_grad():
            logits, _ = prefill(
                mparams, c, torch.tensor([seq], device=device),
                torch.arange(T, device=device)[None],
                torch.ones((1, T), dtype=torch.int32, device=device),
                KVCache.zeros(c, 1, T, device))
            lp = torch.log_softmax(logits[0].float(), dim=-1)
            tgt = torch.tensor(seq[1:], device=device)
            out = lp[:-1].gather(1, tgt[:, None])[:, 0]
        return out[len(mo.prompt_ids) - 1:].cpu().numpy()

    gap = _gap(np.asarray(mo.output_logprobs), plain_logprobs(mcfg))
    gap_global = _gap(np.asarray(mo.output_logprobs), plain_logprobs(
        dataclasses.replace(mcfg, sliding_window=None)))
    if not _gap_gate("Mistral window-gather decode against the windowed "
                     "forward", gap, *window_tol, phase="features"):
        raise AssertionError("the window-gather path disagrees")
    if _gap_gate("control: the same tokens against the forward without the "
                 "window (global attention), which must fail", gap_global,
                 *window_tol, phase="features"):
        raise AssertionError("the window gate cannot tell a window from "
                             "none")
    res["mistral"] = dict(secs=msecs, chunks=chunks, launches=fd, gap=gap,
                          gap_global=gap_global,
                          setup_s=time.perf_counter() - tik - msecs)
    del eng, mparams
    if device.type == "cuda":
        torch.cuda.empty_cache()
    res["secs"] = time.perf_counter() - t_phase
    log(f"features phase: {res['secs']:.1f} s")
    return res


def package_line() -> str:
    """Which of the data path's and the control plane's packages import on
    this machine, with their versions."""
    import importlib

    got = []
    for name in ("transformers", "tokenizers", "zmq", "safetensors"):
        try:
            mod = importlib.import_module(name)
            got.append(f"{name} {getattr(mod, '__version__', '?')}")
        except ImportError:
            got.append(f"{name} missing")
    return ", ".join(got)


def async_inputs(tmp, vocab, *, rows=ASYNC_ROWS, words=ASYNC_PROMPT_WORDS,
                 n_answers=ASYNC_ANSWER_WORDS, seed=SEED):
    """The async-PPO phase's tokenizer and dataset, in ``tmp``: a word-level
    tokenizer with ``vocab`` entries (``[UNK]``, ``[PAD]``, ``[EOS]``,
    ``n_answers`` words that each spell the right answer, then ``w<i>``),
    so that every id the model samples decodes, saved as a transformers
    tokenizer directory; and ``rows`` math rows (prompts of ``words``
    words drawn from numpy seed ``seed``, the solution ``\\\\boxed{42}``)
    as jsonl.  Returns (tokenizer dir, dataset path)."""
    import importlib.util
    import json
    import os

    import numpy as np

    missing = [n for n in ("transformers", "tokenizers")
               if importlib.util.find_spec(n) is None]
    if missing:
        raise AssertionError(
            f"async-PPO phase: {', '.join(missing)} not installed here; the "
            "data path loads its tokenizer through transformers "
            "(api/dataset_api.py load_hf_tokenizer)")
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import WhitespaceSplit
    from transformers import PreTrainedTokenizerFast

    special = ["[UNK]", "[PAD]", "[EOS]"]
    answers = [f"\\boxed{{{42 * k}/{k}}}" for k in range(1, n_answers + 1)]
    plain = [f"w{i}" for i in range(vocab - len(special) - len(answers))]
    tok = Tokenizer(WordLevel(
        {w: i for i, w in enumerate(special + answers + plain)},
        unk_token="[UNK]"))
    tok.pre_tokenizer = WhitespaceSplit()
    tok_dir = os.path.join(tmp, "tokenizer")
    PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token="[UNK]", pad_token="[PAD]",
        eos_token="[EOS]").save_pretrained(tok_dir)
    rng = np.random.default_rng(seed)
    path = os.path.join(tmp, "math.jsonl")
    with open(path, "w") as f:
        for i in range(rows):
            n = int(rng.integers(words[0], words[1] + 1))
            ids = rng.integers(0, len(plain), n)
            f.write(json.dumps(dict(
                query_id=f"q{i}", task="math",
                prompt=" ".join(plain[j] for j in ids),
                solutions=["\\boxed{42}"])) + "\n")
    return tok_dir, path


def token_version_gate(tag, train_steps, member,
                       offpolicyness=ASYNC_OFFPOLICYNESS):
    """Every trajectory a train step consumed: its tokens' versions
    non-decreasing, the first not earlier than its ``version_start`` (a
    swap that applies while its prompt fills gives the first token a later
    one, as in the reference), the last its ``version_end``, and the step's
    version within ``max_head_offpolicyness`` of its start.  ``member(rec,
    sid)`` gives ``(per-token versions, version_start, version_end)`` as the
    rollout recorded them.  Returns the staleness histogram."""
    from collections import Counter

    staleness = Counter()
    late_start = 0
    for rec in train_steps:
        k = rec["version"]
        for sid, vs, ve in zip(rec["ids"], rec["version_start"],
                               rec["version_end"]):
            versions, v0, v1 = member(rec, sid)
            if (versions != sorted(versions) or not versions
                    or versions[0] < vs or versions[-1] != ve
                    or (v0, v1) != (vs, ve)):
                raise AssertionError(f"{tag}: {sid}: token versions "
                                     f"{versions}, trajectory {vs}-{ve}")
            if k - vs > offpolicyness or vs > k:
                raise AssertionError(f"{tag}: {sid} (from v{vs}) trained at "
                                     f"step version {k}")
            staleness[k - vs] += 1
            late_start += versions[0] > vs
    log(f"{tag}: {sum(staleness.values())} trajectories consumed; staleness "
        f"(train version - the version at admission): "
        f"{dict(sorted(staleness.items()))}; per-token versions "
        f"non-decreasing in every answer; {late_start} admitted under one "
        f"version and first sampled under a later one (a swap applied while "
        f"the prompt filled)")
    return staleness


def logprob_gap_gate(tag, inference_recs, versions_of):
    """actor_inf's ``prox_logp`` against the behaviour logprobs (the
    server's, or sync PPO's generation's) on
    the response tokens sampled under the trainer's version at that call
    (``versions_of(rec, sid)``: a member's per-token versions), within
    TOL_PROX_MEAN / TOL_PROX_MAX.  Returns (mean, max)."""
    import numpy as np

    diffs = []
    for rec in inference_recs:
        k = rec["version"]
        mask = np.asarray(rec["prompt_mask"], bool)
        behav, prox = np.asarray(rec["behav"]), np.asarray(rec["prox"])
        starts = np.cumsum([0] + rec["lens"][:-1])
        # logprobs are [L-1] per sequence, packed
        lp_starts = np.cumsum([0] + [n - 1 for n in rec["lens"][:-1]])
        for sid, s0, lp0, n in zip(rec["ids"], starts, lp_starts,
                                   rec["lens"]):
            versions = versions_of(rec, sid)
            # transition t predicts token t + 1; the j-th response
            # transition samples output token j
            resp = np.flatnonzero(~mask[s0 + 1:s0 + n])
            mine = [t for j, t in enumerate(resp) if versions[j] == k]
            if mine:
                idx = lp0 + np.asarray(mine)
                diffs.append(np.abs(prox[idx] - behav[idx]))
    d = np.concatenate(diffs) if diffs else np.zeros(0)
    gap = (float(d.mean()) if d.size else float("nan"),
           float(d.max()) if d.size else float("nan"))
    log(f"{tag}: actor_inf prox_logp against the generation's behaviour "
        f"logprobs on {d.size} tokens sampled under the trainer's version: "
        f"mean {gap[0]:.3e} (tol {TOL_PROX_MEAN}), max {gap[1]:.3e} (tol "
        f"{TOL_PROX_MAX})")
    if not d.size or not (gap[0] <= TOL_PROX_MEAN and gap[1] <= TOL_PROX_MAX):
        raise AssertionError(f"{tag}: served and trained logprobs disagree")
    return gap


def async_ppo_phase(cfg, device, card, hf_dir, *, rows=ASYNC_ROWS,
                    prompt_words=ASYNC_PROMPT_WORDS,
                    train_bs=ASYNC_TRAIN_BS, new_tokens=ASYNC_NEW_TOKENS,
                    chunk_tokens=ASYNC_CHUNK_TOKENS,
                    max_tokens_per_mb=MAX_TOKENS_PER_MB, steps=ASYNC_STEPS,
                    offpolicyness=ASYNC_OFFPOLICYNESS,
                    n_answers=ASYNC_ANSWER_WORDS, timeout=600.0, **exp_kw):
    """The whole async-PPO loop through the port's entry point:
    ``AsyncPPOMathExperiment`` at the recipe's settings (with the cuts of
    the ASYNC_* constants) through ``run_experiment_local``: a generation
    server, the gserver manager, two rollout workers running the math
    single-step agent and environment, the master, and a model worker that
    hosts the actor (float32 master weights, AdamW), runs actor_inf and
    actor_train and publishes every version, which the manager stages and
    commits into the server.  Trainer and server both load the HF
    directory ``hf_dir`` (the recipe's ``actor.type_: hf``;
    :func:`write_hf_dir` writes one) and the trainer saves an HF directory
    at its last step (``save_freq_steps`` = ``steps``).

    The phase observes the run through wrappers of the workers' methods
    (restored afterwards) and gates: at least ``steps`` master steps, each
    with a finite ``actor_train/loss`` and an ``actor_train/kl``; the
    server at version 2 or more, through the manager's swaps; every
    consumed trajectory within ``max_head_offpolicyness`` of its train
    step, its tokens' versions non-decreasing; every published version's
    manifest valid against the server's template, with its int8 sibling
    advertised, written and of the int8 tree's layout; the served weights
    bit-identical to the published snapshot of their version; actor_inf's
    logprobs against the server's behaviour logprobs on the tokens sampled
    under the trainer's version (TOL_PROX_MEAN / TOL_PROX_MAX); the paged
    and flash launches against the work the engine and the trainer
    dispatched; the leak audit of the server's pool; the trainer and the
    server built from ``hf_dir``, and one HF save that names
    ``Qwen2ForCausalLM`` and reloads bit-identical to the trainer's final
    float32 weights.  ``exp_kw`` overrides experiment fields (CPU
    rehearsals)."""
    import os
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch

    from areal_tpu_torch.api.config import DatasetAbstraction, ModelAbstraction
    from areal_tpu_torch.api.data import MicroBatchSpec
    from areal_tpu_torch.api.model_api import GenerationHyperparameters
    from areal_tpu_torch.api.system_api import ExperimentSaveEvalControl
    from areal_tpu_torch.apps.local_runner import run_experiment_local
    from areal_tpu_torch.base import constants, name_resolve
    from areal_tpu_torch.engine import backend, checkpoint
    from areal_tpu_torch.engine.optimizer import OptimizerConfig
    from areal_tpu_torch.experiments.async_ppo_exp import (
        AsyncPPOMathExperiment,
    )
    from areal_tpu_torch.experiments.ppo_math_exp import PPOHyperparameters
    from areal_tpu_torch.models import quantize
    from areal_tpu_torch.observability import get_registry
    from areal_tpu_torch.ops import paged_attention as pa
    from areal_tpu_torch.ops.flash_attention import flash_attention as fa
    from areal_tpu_torch.system import gserver_manager as gm
    from areal_tpu_torch.system import model_worker as mw
    from areal_tpu_torch.system import partial_rollout as pr
    from areal_tpu_torch.system.generation_server import GenerationServerWorker

    tag = "async-ppo"
    log(f"{tag}: packages: {package_line()}")
    t_phase = time.perf_counter()
    cuda = device.type == "cuda"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_async_")
    env0 = {k: os.environ.get(k) for k in ("AREAL_LOG_ROOT", "AREAL_SAVE_ROOT")}
    os.environ["AREAL_LOG_ROOT"] = os.path.join(tmp, "logs")
    os.environ["AREAL_SAVE_ROOT"] = os.path.join(tmp, "save")
    name_resolve.reconfigure("memory")
    reg = get_registry()
    L = cfg.n_layers

    # -- what the wrappers record -----------------------------------------
    servers, fetch_s, publishes, manifests, swaps, stage_rpcs = [], [], [], [], [], []
    builds, saves = [], []  # make_model calls; HF saves
    members = {}  # member qid -> (per-token versions, start, end)
    mfcs = []  # one record per actor_inf / actor_train call
    failures = []  # raised by the wrappers' checks, re-raised here
    originals = []

    def patch(owner, name, make):
        orig = getattr(owner, name)
        originals.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def on_configure(orig):
        def f(self, config):
            servers.append(self)
            return orig(self, config)
        return f

    def on_gen_one(orig):
        async def f(self, qid, prompt_ids, root=None, presched=None):
            out = await orig(self, qid, prompt_ids, root=root,
                             presched=presched)
            members[qid] = (list(out.output_versions), out.version_start,
                            out.version_end)
            return out
        return f

    def on_fetch(orig):
        def f(self, batch_size):
            tik = time.perf_counter()
            try:
                return orig(self, batch_size)
            finally:
                fetch_s.append(time.perf_counter() - tik)
        return f

    def hist_sum(part):
        return reg.histogram("areal_weight_publish_seconds").snapshot(
            part=part)[0]

    def on_publish(orig):
        def f(self, model_name):
            s0 = {p: hist_sum(p) for p in ("full", "int8")}
            tik = time.perf_counter()
            out = orig(self, model_name)
            publishes.append(dict(
                version=self._models[model_name].version.global_step,
                host_s=time.perf_counter() - tik,
                **{p: hist_sum(p) - s0[p] for p in ("full", "int8")}))
            return out
        return f

    def on_manifest(orig):
        def f(params, path, version=None, serving_quant=None):
            out = orig(params, path, version=version,
                       serving_quant=serving_quant)
            if serving_quant is None:  # not a trainer publish
                return out
            try:
                template = servers[0].engine.weight_restore_template("full")
                problems = checkpoint.validate_manifest(template, out)
                entry = serving_quant["int8"]
                qdir = os.path.join(os.path.dirname(path), entry["dir"])
                # the int8 tree's layout: leaves and shapes, int8 weights
                # and float32 scales (other leaves may differ in float
                # width, which a restore casts)
                qtemplate = quantize.quant_tree_struct(_tree_map(
                    lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), template))
                problems += [f"int8 tree: {p}" for p in
                             checkpoint.validate_manifest(qtemplate, entry)]
                problems += [
                    f"int8 tree: {k} is {v['dtype']}"
                    for k, v in entry["leaves"].items()
                    if (k.endswith("/qw") and v["dtype"] != "int8")
                    or (k.endswith("/scale") and "norm" not in k
                        and v["dtype"] != "float32")]
                if not os.path.exists(os.path.join(
                        qdir, checkpoint.TENSORS_NAME)):
                    problems.append(f"no int8 tensors in {qdir}")
                manifests.append(dict(
                    version=version, problems=problems,
                    bytes=os.path.getsize(os.path.join(
                        path, checkpoint.TENSORS_NAME)),
                    int8_bytes=os.path.getsize(os.path.join(
                        qdir, checkpoint.TENSORS_NAME)),
                    n_int8=sum(k.endswith("/qw") for k in entry["leaves"])))
            except Exception as e:  # noqa: BLE001 - raised below
                failures.append(f"manifest v{version}: {e!r}")
            return out
        return f

    def on_update_one(orig):
        def f(self, addr, client, payload, timeout=None):
            tik = time.perf_counter()
            out = orig(self, addr, client, payload, timeout=timeout)
            stage_rpcs.append(dict(version=payload["version"],
                                   mode=payload.get("mode", "full"),
                                   s=time.perf_counter() - tik))
            return out
        return f

    def on_flush(orig):
        def f(self, info):
            tik = time.perf_counter()
            out = orig(self, info)
            swaps.append(dict(
                version=info["version"], applied=self._model_version,
                round_s=time.perf_counter() - tik,
                pause_s=reg.gauge(
                    "areal_gserver_weight_update_pause_seconds").value()))
            return out
        return f

    def on_rpc(orig):
        def f(self, req):
            spec = req.data
            handle, ids = spec["handle_name"], list(spec["ids"])
            model = self._models[spec["model_name"]]
            k = model.version.global_step
            rec = dict(handle=handle, version=k, ids=ids)
            try:
                if handle == "train_step":
                    v = self._data_manager.get_batch(
                        ids, ["version_start", "version_end"])
                    rec["version_start"] = np.asarray(
                        v.data["version_start"]).reshape(-1).tolist()
                    rec["version_end"] = np.asarray(
                        v.data["version_end"]).reshape(-1).tolist()
            except Exception as e:  # noqa: BLE001 - raised below
                failures.append(f"train_step record: {e!r}")
            out = orig(self, req)
            try:
                if handle == "inference":
                    rec["n_mbs"] = model.engine.last_forward_mbs
                    b = self._data_manager.get_batch(ids, [
                        "packed_input_ids", "packed_logprobs", "prompt_mask",
                        "prox_logp"])
                    rec["lens"] = [l[0] for l in
                                   b.seqlens["packed_input_ids"]]
                    rec["prompt_mask"] = np.asarray(b.data["prompt_mask"])
                    rec["behav"] = np.asarray(b.data["packed_logprobs"])
                    rec["prox"] = np.asarray(b.data["prox_logp"])
                elif handle == "train_step":
                    rec["n_mbs"] = int(out["stats"]["n_mbs"])
                    rec["stats"] = dict(out["stats"])
                rec["elapsed"] = out.get("elapsed", 0.0)
            except Exception as e:  # noqa: BLE001 - raised below
                failures.append(f"{handle} record: {e!r}")
            mfcs.append(rec)
            return out
        return f

    def on_make_model(orig):
        def f(cfg, *a, dtype=None, **kw):
            builds.append(dict(type_=cfg.type_, path=cfg.args.get("path"),
                               dtype=dtype))
            return orig(cfg, *a, dtype=dtype, **kw)
        return f

    def on_save(orig):
        def f(self, model_name, path):
            tik = time.perf_counter()
            orig(self, model_name, path)
            engine = self._models[model_name].engine
            saves.append(dict(path=path, engine=engine,
                              version=engine.version,
                              s=time.perf_counter() - tik,
                              bytes=_dir_bytes(path)))
        return f

    patch(GenerationServerWorker, "_configure", on_configure)
    patch(backend, "make_model", on_make_model)
    patch(mw.ModelWorker, "_save_model", on_save)
    patch(pr.PartialRolloutManager, "_gen_one", on_gen_one)
    patch(mw.ModelWorker, "_handle_fetch", on_fetch)
    patch(mw.ModelWorker, "_publish_weights", on_publish)
    patch(mw.ModelWorker, "_handle_model_rpc", on_rpc)
    patch(checkpoint, "write_manifest", on_manifest)
    patch(gm.GserverManager, "_update_one_server", on_update_one)
    patch(gm.GserverManager, "_flush_and_update", on_flush)

    model_abs = ModelAbstraction(
        "hf", {"path": hf_dir, "remat": True, "dtype": cfg.dtype})
    exp_args = dict(
        experiment_name="chipsmoke", trial_name="asyncppo",
        n_model_workers=1, force_cpu_devices=None if cuda else 1,
        exp_ctrl=ExperimentSaveEvalControl(
            total_train_epochs=1, benchmark_steps=steps,
            save_freq_steps=steps),
        actor=model_abs, train_bs_n_seqs=train_bs, group_size=16,
        mb_spec=MicroBatchSpec(max_tokens_per_mb=max_tokens_per_mb),
        actor_optimizer=OptimizerConfig(lr=TRAIN_LR,
                                        warmup_steps_proportion=0.0),
        ppo=PPOHyperparameters(
            gen=GenerationHyperparameters(max_new_tokens=new_tokens,
                                          temperature=1.0),
            ppo_n_minibatches=PPO_RECIPE["n_minibatches"],
            kl_ctl=PPO_RECIPE["kl_ctl"],
            disable_value=PPO_RECIPE["disable_value"],
            use_decoupled_loss=PPO_RECIPE["use_decoupled_loss"],
            behav_imp_weight_cap=PPO_RECIPE["behav_imp_weight_cap"]),
        n_rollout_workers=2, n_gen_servers=1,
        max_head_offpolicyness=offpolicyness,
        max_concurrent_rollouts=ASYNC_MAX_ROLLOUTS,
        new_tokens_per_chunk=chunk_tokens,
        gen_kv_cache_len=LONG_KV_CACHE_LEN,
        gen_max_concurrent_batch=LONG_MAX_BATCH,
    )
    exp_args.update(exp_kw)
    for fn in (pa.paged_flash_attention, pa.paged_flash_attention_deep):
        fn.launches = fn.int8_launches = 0
    pa.paged_flash_attention.prefill_launches = 0
    fa.fwd_launches = fa.bwd_launches = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    try:
        tok_dir, data_path = async_inputs(tmp, cfg.vocab_size, rows=rows,
                                          words=prompt_words,
                                          n_answers=n_answers)
        exp = AsyncPPOMathExperiment(
            tokenizer_path=tok_dir,
            dataset=DatasetAbstraction("math_code_prompt", {
                "dataset_path": data_path, "max_length": ASYNC_MAX_LENGTH}),
            **exp_args)
        xcfg = exp.initial_setup()
        log(f"{tag}: AsyncPPOMathExperiment: trainer graph "
            f"{[r.name for r in xcfg.master.model_rpcs]}, "
            f"{len(xcfg.gen_servers)} generation server, "
            f"{len(xcfg.rollout_workers)} rollout workers; train_bs_n_seqs "
            f"{train_bs}, group_size 16, {new_tokens} new tokens in chunks of "
            f"{chunk_tokens}, max_concurrent_rollouts {ASYNC_MAX_ROLLOUTS}, "
            f"max_head_offpolicyness {offpolicyness}, "
            f"max_tokens_per_mb {max_tokens_per_mb}, lr {TRAIN_LR} without "
            f"warm-up, {steps} steps; {rows} rows, the tokenizer's "
            f"{cfg.vocab_size} words")
        tik = time.perf_counter()
        master = run_experiment_local(xcfg, timeout=timeout)
        run_s = time.perf_counter() - tik
        # the last publish's commit may still be writing
        deadline = time.perf_counter() + 120
        while (len(manifests) < len(publishes)
               and time.perf_counter() < deadline and not failures):
            time.sleep(0.1)
        trial_save = constants.get_param_realloc_path()
    finally:
        for owner, name, orig in reversed(originals):
            setattr(owner, name, orig)
        for k, v in env0.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if failures:
        raise AssertionError(f"{tag}: {failures}")
    (server,) = servers
    eng = server.engine

    # -- the master's steps ---------------------------------------------
    hist = master.stats_history
    for i, st in enumerate(hist):
        log(f"{tag}: step {i + 1}: wall {st['time_perf/e2e']:.3f} s, "
            f"actor_train/loss {st['actor_train/loss']:.6e}, grad_norm "
            f"{st['actor_train/grad_norm']:.6e}, kl {st['actor_train/kl']:.3e}, "
            f"reward_mean {st['actor_train/reward_mean']:.4f}, n_tokens "
            f"{st['actor_train/n_tokens']:.0f}, actor_inf "
            f"{st['actor_inf/elapsed']:.3f} s, actor_train "
            f"{st['actor_train/elapsed']:.3f} s")
    if len(hist) < steps or not all(
            math.isfinite(st["actor_train/loss"]) and "actor_train/kl" in st
            for st in hist):
        raise AssertionError(f"{tag}: master stats {hist}")

    # -- swaps: the server's version came through the manager ------------
    applied = [s["applied"] for s in swaps]
    log(f"{tag}: publishes {[(p['version'], round(p['full'], 3), round(p['int8'], 3)) for p in publishes]} "
        f"(version, full, int8 seconds); swap rounds {swaps}; stage/commit "
        f"RPCs {stage_rpcs}")
    # every publish but the last is swapped in before the run ends; the
    # last one's round may still be in flight when the master ends, and its
    # commit may land as the manager's clients close
    if (not applied or max(applied) < steps - 1
            or eng.version not in (max(applied), steps)):
        raise AssertionError(f"{tag}: the server ended at v{eng.version}; "
                             f"the manager applied {applied}")

    # -- staleness and versions per token --------------------------------
    staleness = token_version_gate(
        tag, [r for r in mfcs if r["handle"] == "train_step"],
        lambda rec, sid: members[sid], offpolicyness)

    # -- manifests and the int8 siblings ----------------------------------
    for m in manifests:
        log(f"{tag}: manifest v{m['version']}: {len(m['problems'])} problems "
            f"against the server's template; {m['bytes'] / 1e9:.3f} GB full, "
            f"int8 sibling {m['int8_bytes'] / 1e9:.3f} GB with "
            f"{m['n_int8']} int8 projections advertised")
    published = sorted(p["version"] for p in publishes)
    if (sorted(m["version"] for m in manifests) != published
            or any(m["problems"] or not m["n_int8"] for m in manifests)):
        raise AssertionError(f"{tag}: manifests {manifests} for publishes "
                             f"{published}")

    # -- trainer and server from the HF directory, and its HF save -------
    log(f"{tag}: make_model calls {builds}; HF saves "
        f"{[(os.path.basename(x['path']), x['version'], round(x['s'], 3), x['bytes']) for x in saves]}"
        f" (dir, trainer version, seconds, bytes)")
    got = sorted((b["type_"], b["path"], str(b["dtype"])) for b in builds)
    if got != sorted([("hf", hf_dir, str(torch.float32)),
                      ("hf", hf_dir, "None")]):
        raise AssertionError(f"{tag}: trainer and server were not both "
                             f"built from {hf_dir}: {builds}")
    if len(saves) != 1:
        raise AssertionError(f"{tag}: {len(saves)} HF saves, expected 1")
    (save,) = saves
    from areal_tpu_torch.models.hf import load_hf_model

    with open(os.path.join(save["path"], "config.json")) as f:
        arch = json.load(f)["architectures"]
    tik = time.perf_counter()
    _, reloaded = load_hf_model(save["path"], device=device)
    _sync(device)
    t_reload = time.perf_counter() - tik
    trainer = save.pop("engine")
    same = (trainer.version == save["version"]
            and _bit_equal(reloaded, trainer.params))
    del reloaded, trainer
    log(f"{tag}: the HF save at trainer version {save['version']} "
        f"({save['bytes'] / 1e9:.3f} GB of float32, written in "
        f"{save['s']:.3f} s) names {arch}, reloads in {t_reload:.3f} s "
        f"bit-identical to the trainer's final weights: {same}")
    if arch != ["Qwen2ForCausalLM"] or not same:
        raise AssertionError(f"{tag}: the HF save differs from the "
                             "trainer's final weights")
    save["reload_s"] = t_reload

    # -- the served weights are the published weights --------------------
    snap = os.path.join(trial_save, "actor", f"v{eng.version}")
    served = checkpoint.load_params_like(eng.params, snap)
    ref, got = _by_path(served), _by_path(eng.params)
    # a server widens its norm scales to float32, exactly
    same = ref.keys() == got.keys() and all(
        torch.equal(ref[k].to(got[k].dtype), got[k]) for k in got)
    del served, ref, got
    log(f"{tag}: the served v{eng.version} tree is bit-identical to the "
        f"published snapshot: {same}")
    if not same:
        raise AssertionError(f"{tag}: the served weights differ from v"
                             f"{eng.version}'s snapshot")

    # -- logprobs: actor_inf against the behaviour logprobs ---------------
    gap = logprob_gap_gate(
        tag, [r for r in mfcs if r["handle"] == "inference"],
        lambda rec, sid: members[sid][0])

    # -- launches -----------------------------------------------------------
    inf_mbs = sum(r["n_mbs"] for r in mfcs if r["handle"] == "inference")
    train_mbs = sum(r["n_mbs"] for r in mfcs if r["handle"] == "train_step")
    want_fa = ((L * inf_mbs + 2 * L * train_mbs, L * train_mbs) if cuda
               else (0, 0))
    got_fa = (fa.fwd_launches, fa.bwd_launches)
    log(f"{tag}: flash launches fwd/bwd {got_fa} for {inf_mbs} actor_inf and "
        f"{train_mbs} actor_train micro-batches (expected {want_fa})")
    if got_fa != want_fa:
        raise AssertionError(f"{tag}: flash launches {got_fa}, expected "
                             f"{want_fa}")
    gate = LaunchGate(eng, L, False)
    gate.w0 = (0, 0, 0, 0, 0)
    if cuda:
        work = gate.check(f"{tag}, the server's whole run")
    else:
        work = dict(fills=eng.prefill_calls, chunks=eng.decode_chunks_total)
    decode_toks = eng.decode_tokens_total
    # every worker thread has stopped before the pool is audited
    names = {w.worker_name for w in xcfg.model_workers + xcfg.rollout_workers
             + xcfg.gen_servers} | {xcfg.gserver_manager.worker_name, "master"}
    for t in threading.enumerate():
        if t.name in names:
            t.join(120)
            if t.is_alive():
                raise AssertionError(f"{tag}: {t.name} did not stop")
    # the run ends with requests in flight (the rollout workers stop
    # mid-answer) and maybe inside a swap round, with the server paused by
    # the manager: the audit cancels what is left and steps the engine,
    # which a pause would hold
    paused = eng._paused.is_set()
    eng.resume()
    live = ([r.qid for r in list(eng._pending)]
            + [r.req.qid for r in eng._preempted]
            + [r.req.qid for r in eng.rows if r is not None and not r.parked])
    for qid in live:
        eng.cancel(qid)
    for _ in range(10000):
        if not (eng._cancel_wanted or eng.inflight_chunks):
            break
        eng.step()
    else:
        raise AssertionError(f"{tag}: cancelling {live} did not settle: "
                             f"{eng._cancel_wanted}, {eng.inflight_chunks}")
    log(f"{tag}: the server stopped at v{eng.version}"
        + (" inside a swap round (paused)" if paused else "")
        + f" with {len(live)} requests in flight, cancelled for the audit")
    audit_pool(eng, tag)
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
    del eng, server, servers
    shutil.rmtree(tmp, ignore_errors=True)
    if cuda:
        torch.cuda.empty_cache()

    walls = [st["time_perf/e2e"] for st in hist]
    secs = time.perf_counter() - t_phase
    res = dict(
        launches=dict(gate.total, fwd=got_fa[0], bwd=got_fa[1]),
        step_s=walls, fetch_wait_s=sum(fetch_s), run_s=run_s,
        decode_tok_s=decode_toks / run_s, publishes=publishes, swaps=swaps,
        staleness=dict(staleness), gap=gap, peak_gib=peak, phase_s=secs,
        work=work, saves=saves)
    log(f"{tag}: step walls {[round(w, 3) for w in walls]} s; the trainer "
        f"waited {sum(fetch_s):.3f} s for data in {len(fetch_s)} fetches; "
        f"fleet decode {decode_toks} tokens in the {run_s:.1f} s run = "
        f"{decode_toks / run_s:.1f} tokens/s; publish (host copy, full / "
        f"int8) {[(p['version'], round(p['full'], 3), round(p['int8'], 3)) for p in publishes]} s; "
        f"stage RPCs {[(r['version'], r['mode'], round(r['s'], 3)) for r in stage_rpcs]} s; "
        f"pause {[(w['version'], round(w['pause_s'], 3)) for w in swaps]} s; "
        f"peak device memory {peak:.2f} GiB; phase {secs:.1f} s, on {card}")
    return res


def mark_generation(gen, sink, on_first_decode=None, also=()):
    """Wrap ``engine/generation.py``'s ``decode_step``,
    ``sample_logits_keyed`` and ``_is_stop`` (module functions that
    ``generate_loop`` looks up at each call), and the ``(module, name)``
    functions of ``also``, so that each call appends ``(name, "in" /
    "out", host seconds)`` to the list ``sink()`` returns.
    ``on_first_decode`` runs once, before the first decode step's mark.
    Returns the originals, for :func:`unmark_generation`.  The wrappers
    add two clock reads a call and no device work."""
    targets = [(gen, n) for n in
               ("decode_step", "sample_logits_keyed", "_is_stop")]
    originals = {(o, n): getattr(o, n) for o, n in targets + list(also)}
    first = [on_first_decode]

    def wrap(name, orig):
        def f(*a, **kw):
            if name == "decode_step" and first[0] is not None:
                cb, first[0] = first[0], None
                cb()
            sink().append((name, "in", time.perf_counter()))
            out = orig(*a, **kw)
            sink().append((name, "out", time.perf_counter()))
            return out
        return f

    for (o, n), orig in originals.items():
        setattr(o, n, wrap(n, orig))
    return originals


def unmark_generation(originals):
    for (o, n), orig in originals.items():
        setattr(o, n, orig)


def decode_step_split(marks):
    """Host seconds of each decode step of one ``generate_loop`` call from
    its marks (:func:`mark_generation`, with ``("loop", "in" / "out", t)``
    around the call): rows of (wall from this step's ``decode_step`` to
    the next one's or the loop's end, ``decode_step``'s host time (the
    model's enqueue), ``sample_logits_keyed``'s, the rest of the step up
    to ``_is_stop``'s return, and the wait after it, which holds the
    step's one sync: ``active.any()``).  Also (the prefill's seconds, from
    the loop's start to the first decode step, its first token and its
    sync included; the loop's seconds)."""
    import numpy as np

    rows, cur, t_loop, t_first = [], None, None, None
    for name, edge, t in marks:
        if name == "loop" and edge == "in":
            t_loop = t
        elif (name == "decode_step" and edge == "in") or name == "loop":
            if cur is not None:
                rows.append((t - cur["t0"], cur["model"], cur["sample"],
                             cur["stop"] - cur["t0"] - cur["model"]
                             - cur["sample"], t - cur["stop"]))
            cur = dict(t0=t) if name == "decode_step" else None
            if t_first is None and name == "decode_step":
                t_first = t
            if name == "loop":
                t_end = t
        elif cur is not None:
            if name == "decode_step":
                cur["model"] = t - cur["t0"]
            elif name == "sample_logits_keyed":
                cur["s_in" if edge == "in" else "sample"] = (
                    t if edge == "in" else t - cur["s_in"])
            elif name == "_is_stop" and edge == "out":
                cur["stop"] = t
    prefill_s = (t_end if t_first is None else t_first) - t_loop
    return np.array(rows, dtype=np.float64).reshape(-1, 5), prefill_s, \
        t_end - t_loop


def split_line(rows):
    """One line of :func:`decode_step_split`'s rows: means (medians) in
    ms."""
    import numpy as np

    if len(rows) == 0:
        return "no decode steps"
    mean, med = rows.mean(axis=0) * 1e3, np.median(rows, axis=0) * 1e3
    names = ("wall", "host enqueue: the model", "sampling", "the rest",
             "wait at the step's sync")
    return ", ".join(f"{n} {a:.3f} ({b:.3f})"
                     for n, a, b in zip(names, mean, med)) + " ms a step"


def decode_anatomy(cfg, device, hf_dir, loop_args):
    """Where a decode step of sync PPO's generation spends its time: the
    last ``generate_loop`` call of the phase (its prompts ``[B, T]``,
    lengths, seed, sampling and cache length, ``loop_args``) replayed on
    the ``hf_dir`` weights in the serving types for ANAT_DECODE_STEPS
    decode steps (no stop tokens, so every row runs each step).  A warm-up
    call, then a call with the host marks of :func:`mark_generation` (each
    step's wall, its host enqueue by part, of which ``flash_decode``'s
    wrapper, and its wait at the sync), then, on a card, a
    call under ``torch.profiler`` (device activity only) started at the
    first decode step: device busy time a step (kernels and copies), its
    kernel count, and the rows with the most time.  Idle share = 1 -
    device busy / the unprofiled wall."""
    import torch

    from areal_tpu_torch.engine import generation as gen
    from areal_tpu_torch.models.convert import serving_params
    from areal_tpu_torch.models.hf import load_hf_model
    from areal_tpu_torch.ops import decode_attention as da

    steps = ANAT_DECODE_STEPS
    tokens, lens, seed, sampling, cache_len = loop_args
    cuda = device.type == "cuda"
    _, master = load_hf_model(hf_dir, device=device)
    params = serving_params(master, cfg)
    del master
    tokens, lens = tokens.to(device), lens.to(device)
    counts0 = gen.counters.decode_steps

    def call(marks, on_first_decode=None):
        originals = mark_generation(gen, lambda: marks, on_first_decode,
                                    also=[(da, "_launch")])
        try:
            marks.append(("loop", "in", time.perf_counter()))
            gen.generate_loop(params, cfg, tokens, lens, seed,
                              max_new_tokens=steps + 1, min_new_tokens=0,
                              stop_tokens=(), sampling=sampling,
                              cache_len=cache_len)
            marks.append(("loop", "out", time.perf_counter()))
        finally:
            unmark_generation(originals)
        return decode_step_split(marks)

    call([])
    marks = []
    rows, prefill_s, loop_s = call(marks)
    # the kernel wrapper's host work (checks, outputs, split workspace,
    # tickets, the launch), inside the model's enqueue
    t_in = [t for n, e, t in marks if n == "_launch" and e == "in"]
    t_out = [t for n, e, t in marks if n == "_launch" and e == "out"]
    wrapper = sum(b - a for a, b in zip(t_in, t_out)) / steps
    if len(t_in) != (cfg.n_layers * steps if cuda else 0):
        raise AssertionError(f"decode anatomy: {len(t_in)} flash_decode "
                             f"launches in {steps} decode steps")
    if len(rows) != steps:
        raise AssertionError(f"decode anatomy: {len(rows)} decode steps "
                             f"replayed, expected {steps}")
    busy = kernels = None
    top = []
    if cuda:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA], acc_events=True)

        def start():
            torch.cuda.synchronize()
            prof.start()

        call([], on_first_decode=start)
        torch.cuda.synchronize()
        prof.stop()
        busy_s, _ = device_seconds(prof, ())
        if busy_s > 0:
            busy = busy_s / steps
            kernels = sum(
                ev.count for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)) / steps
            top = [(sec / steps, calls / steps, name)
                   for sec, calls, name in top_device_rows(prof, 8)]
    wall = float(rows[:, 0].mean())
    del params
    gen.counters.decode_steps = counts0
    B, T = tokens.shape
    dev = ("device time not measured (no card)" if not cuda else
           "device time not measured (the profiler saw no device events)"
           if busy is None else
           f"device busy {busy * 1e3:.3f} ms a step (idle share "
           f"{1 - busy / wall:.3f}), {kernels:.1f} device rows a step")
    log(f"decode anatomy ({B} rows, prompts padded to {T}, cache "
        f"{cache_len}, {steps} decode steps replayed): {split_line(rows)} "
        f"(flash_decode's wrapper {len(t_in) / steps:.0f} calls, "
        f"{wrapper * 1e3:.3f} ms of the model's); {dev}; prefill with its first token {prefill_s * 1e3:.1f} ms, "
        f"the loop {loop_s * 1e3:.1f} ms")
    for sec, calls, name in top:
        log(f"decode anatomy device time a step: {sec * 1e3:.4f} ms in "
            f"{calls:.1f} calls of {name}")
    return dict(steps=steps, split_ms=(rows.mean(axis=0) * 1e3).tolist(),
                wrapper_ms=wrapper * 1e3,
                busy_ms=None if busy is None else busy * 1e3,
                idle_share=None if busy is None else 1 - busy / wall,
                kernels=kernels, prefill_ms=prefill_s * 1e3,
                top=[(sec * 1e3, calls, name) for sec, calls, name in top])



def sync_ppo_phase(cfg, device, card, hf_dir, *, rows=ASYNC_ROWS,
                   prompt_words=ASYNC_PROMPT_WORDS, train_bs=SYNC_TRAIN_BS,
                   new_tokens=SYNC_NEW_TOKENS, n_answers=ASYNC_ANSWER_WORDS,
                   overrides=()):
    """Sync PPO through the port's entry point: ``PPOMathExperiment`` from
    the recipe's ``training/configs/sync_ppo.yaml`` (``parse_cli``, as
    ``python -m areal_tpu_torch.apps.main_sync_ppo`` reads it) with
    ``mesh_spec=d1``, the critic (``ppo.disable_value=false``) and the
    reference model (``ppo.kl_ctl=SYNC_KL_CTL``), SYNC_STEPS steps of
    ``train_bs`` sequences, ``new_tokens`` new tokens and micro-batches of
    MAX_TOKENS_PER_MB tokens, through ``run_experiment_local``: one model
    worker holds the actor, the critic and the reference model, all three
    loaded from the HF directory ``hf_dir`` (the critic with a zero value
    head), and runs the 7-MFC graph (actor_gen over the dense KV cache,
    rew_inf, ref_inf, critic_inf, actor_inf, actor_train, critic_train).

    Gates: SYNC_STEPS master steps with finite ``actor_train/kl`` and
    ``critic_train/loss``; step 1's KL within TOL_PROX_MEAN of 0 (actor and
    reference load one directory); critic_inf's values all 0 at step 1
    (the zero head) and not all 0 at step 2; actor_inf's logprobs against
    the generation's (TOL_PROX_MEAN / TOL_PROX_MAX); in each actor_gen,
    ``flash_decode`` launches equal to ``n_layers`` x the decode steps the
    generation loop counts itself and flash-forward launches equal to
    ``n_layers`` x its prefills; the whole run's flash launches against the
    micro-batches the MFCs dispatched; the three models built from
    ``hf_dir``; and ``flash_decode`` at the phase's cache shape against its
    plain version, repeated bit-identical.  Also where actor_gen's time
    goes: each decode step's host time by part (:func:`mark_generation`)
    in the run, and the replay of :func:`decode_anatomy` (device busy time
    and idle share a step).  ``overrides`` are further ``key=value``
    arguments (CPU rehearsals)."""
    import numpy as np
    import torch

    from areal_tpu_torch.api.cli_args import parse_cli
    from areal_tpu_torch.apps.local_runner import run_experiment_local
    from areal_tpu_torch.base import name_resolve
    from areal_tpu_torch.engine import backend
    from areal_tpu_torch.engine import generation as gen
    from areal_tpu_torch.experiments.ppo_math_exp import PPOMathExperiment
    from areal_tpu_torch.ops import decode_attention as da
    from areal_tpu_torch.ops.flash_attention import flash_attention as fa
    from areal_tpu_torch.system import model_worker as mw

    tag = "sync-ppo"
    t_phase = time.perf_counter()
    cuda = device.type == "cuda"
    L = cfg.n_layers
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sync_")
    env0 = {k: os.environ.get(k) for k in ("AREAL_LOG_ROOT", "AREAL_SAVE_ROOT")}
    os.environ["AREAL_LOG_ROOT"] = os.path.join(tmp, "logs")
    os.environ["AREAL_SAVE_ROOT"] = os.path.join(tmp, "save")
    name_resolve.reconfigure("memory")

    mfcs, builds, loops, failures, originals = [], [], [], [], []
    timelines, last_loop = [], []

    def patch(owner, name, make):
        orig = getattr(owner, name)
        originals.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def counts():
        return (da.flash_decode.launches, fa.fwd_launches, fa.bwd_launches,
                gen.counters.decode_steps, gen.counters.prefills)

    def on_rpc(orig):
        def f(self, req):
            spec = req.data
            rpc, handle = spec["rpc_name"], spec["handle_name"]
            ids = list(spec["ids"])
            model = self._models[spec["model_name"]]
            # one model worker runs the MFCs in turn, each step's from its
            # actor_gen on
            step = sum(r["handle"] == "generate" for r in mfcs) - (
                handle != "generate")
            rec = dict(rpc=rpc, handle=handle, ids=ids, step=step,
                       version=model.version.global_step)
            c0 = counts()
            out = orig(self, req)
            rec["delta"] = dict(zip(
                ("decode", "fwd", "bwd", "decode_steps", "prefills"),
                (b - a for a, b in zip(c0, counts()))))
            rec["elapsed"] = out.get("elapsed", 0.0)
            try:
                if handle == "generate":
                    out_ids = list(out["meta"].ids)
                    b = self._data_manager.get_batch(out_ids, ["prompt_mask"])
                    rec["new_tokens"] = int(
                        (~np.asarray(b.data["prompt_mask"], bool)).sum())
                elif handle == "inference" and model.engine is not None:
                    rec["n_mbs"] = model.engine.last_forward_mbs
                    if rpc == "actor_inf":
                        b = self._data_manager.get_batch(ids, [
                            "packed_input_ids", "packed_logprobs",
                            "prompt_mask", "prox_logp"])
                        rec["lens"] = [l[0] for l in
                                       b.seqlens["packed_input_ids"]]
                        rec["prompt_mask"] = np.asarray(b.data["prompt_mask"])
                        rec["behav"] = np.asarray(b.data["packed_logprobs"])
                        rec["prox"] = np.asarray(b.data["prox_logp"])
                    elif rpc == "critic_inf":
                        b = self._data_manager.get_batch(
                            ids, ["values", "prompt_mask"])
                        resp = ~np.asarray(b.data["prompt_mask"], bool)
                        rec["values"] = np.asarray(b.data["values"])[resp]
                elif handle == "train_step":
                    rec["n_mbs"] = int(out["stats"]["n_mbs"])
                    rec["stats"] = dict(out["stats"])
            except Exception as e:  # noqa: BLE001 - raised below
                failures.append(f"{rpc} record: {e!r}")
            mfcs.append(rec)
            return out
        return f

    def on_make_model(orig):
        def f(mcfg, *a, dtype=None, **kw):
            builds.append((mcfg.type_, mcfg.args.get("path"),
                           bool(mcfg.args.get("is_critic")), str(dtype)))
            return orig(mcfg, *a, dtype=dtype, **kw)
        return f

    def on_loop(orig):
        def f(params, cfg_, prompt_tokens, prompt_lens, seed, **kw):
            loops.append(dict(B=prompt_tokens.shape[0],
                              T=prompt_tokens.shape[1],
                              cache_len=kw["cache_len"]))
            last_loop[:] = [prompt_tokens.cpu(), prompt_lens.cpu(), seed,
                            kw["sampling"], kw["cache_len"]]
            timelines.append([("loop", "in", time.perf_counter())])
            out = orig(params, cfg_, prompt_tokens, prompt_lens, seed, **kw)
            timelines[-1].append(("loop", "out", time.perf_counter()))
            return out
        return f

    patch(mw.ModelWorker, "_handle_model_rpc", on_rpc)
    patch(backend, "make_model", on_make_model)
    patch(gen, "generate_loop", on_loop)
    originals.extend(
        (o, n, f) for (o, n), f in
        mark_generation(gen, lambda: timelines[-1]).items())
    da.flash_decode.launches = 0
    fa.fwd_launches = fa.bwd_launches = 0
    gen.counters = gen.GenerationCounters()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    recipe = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "training", "configs", "sync_ppo.yaml")
    try:
        tok_dir, data_path = async_inputs(tmp, cfg.vocab_size, rows=rows,
                                          words=prompt_words,
                                          n_answers=n_answers)
        argv = [
            "--config", recipe, "mesh_spec=d1", "experiment_name=chipsmoke",
            "trial_name=syncppo", f"actor.args.path={hf_dir}",
            f"tokenizer_path={tok_dir}",
            f"dataset.args.dataset_path={data_path}",
            f"dataset.args.max_length={ASYNC_MAX_LENGTH}",
            "ppo.disable_value=false", f"ppo.kl_ctl={SYNC_KL_CTL}",
            f"train_bs_n_seqs={train_bs}",
            f"ppo.gen.max_new_tokens={new_tokens}",
            f"mb_spec.max_tokens_per_mb={MAX_TOKENS_PER_MB}",
            f"exp_ctrl.benchmark_steps={SYNC_STEPS}",
            "exp_ctrl.save_freq_steps=null", "exp_ctrl.ckpt_freq_steps=null",
        ] + (["force_cpu_devices=1"] if not cuda else []) + list(overrides)
        exp = parse_cli(PPOMathExperiment, argv)
        xcfg = exp.initial_setup()
        graph = [r.name for r in xcfg.master.model_rpcs]
        log(f"{tag}: PPOMathExperiment from {os.path.basename(recipe)}: graph "
            f"{graph}; models {[str(s.model_name) for s in xcfg.model_workers[0].shards]}; "
            f"train_bs_n_seqs {train_bs}, {new_tokens} new tokens, "
            f"max_tokens_per_mb {MAX_TOKENS_PER_MB}, kl_ctl {SYNC_KL_CTL}, "
            f"{SYNC_STEPS} steps; {rows} rows, the tokenizer's {cfg.vocab_size} "
            f"words")
        want_graph = ["actor_gen", "rew_inf", "ref_inf", "critic_inf",
                      "actor_inf", "actor_train", "critic_train"]
        if graph != want_graph:
            raise AssertionError(f"{tag}: graph {graph}, expected "
                                 f"{want_graph}")
        tik = time.perf_counter()
        master = run_experiment_local(xcfg, timeout=900.0)
        run_s = time.perf_counter() - tik
    finally:
        for owner, name, orig in reversed(originals):
            setattr(owner, name, orig)
        for k, v in env0.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    if failures:
        raise AssertionError(f"{tag}: {failures}")
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0

    # -- the models --------------------------------------------------------
    want = sorted([("hf", hf_dir, False, str(torch.float32)),
                   ("hf", hf_dir, True, str(torch.float32)),
                   ("hf", hf_dir, False, str(torch.float32))])
    if sorted(b for b in builds if b[0] == "hf") != want:
        raise AssertionError(f"{tag}: models built {builds}, expected the "
                             f"actor, the critic and the reference from "
                             f"{hf_dir}")

    # -- the master's steps ------------------------------------------------
    hist = master.stats_history
    by_step = [[r for r in mfcs if r["step"] == k] for k in range(SYNC_STEPS)]
    gen_tok_s = []
    for i, st in enumerate(hist):
        (g,) = [r for r in by_step[i] if r["handle"] == "generate"]
        gen_tok_s.append(g["new_tokens"] / max(g["elapsed"], 1e-9))
        elapsed = {m: round(st[f"{m}/elapsed"], 3) for m in want_graph}
        log(f"{tag}: step {i + 1}: wall {st['time_perf/e2e']:.3f} s; MFC "
            f"seconds {elapsed}; generation {g['new_tokens']} tokens, "
            f"{g['delta']['decode_steps']} decode steps, "
            f"{gen_tok_s[-1]:.1f} tokens/s; actor_train/loss "
            f"{st['actor_train/loss']:.6e}, kl {st['actor_train/kl']:.3e}, "
            f"reward_mean {st['actor_train/reward_mean']:.4f}, "
            f"critic_train/loss {st['critic_train/loss']:.6e}")
    if len(hist) != SYNC_STEPS or not all(
            math.isfinite(st["actor_train/kl"])
            and math.isfinite(st["critic_train/loss"])
            and math.isfinite(st["actor_train/loss"]) for st in hist):
        raise AssertionError(f"{tag}: master stats {hist}")
    kl1 = hist[0]["actor_train/kl"]
    log(f"{tag}: step 1's KL to the reference model {kl1:.3e} (|kl| tol "
        f"{TOL_PROX_MEAN}: actor and reference load one directory)")
    if abs(kl1) > TOL_PROX_MEAN:
        raise AssertionError(f"{tag}: step 1's KL {kl1}")

    # -- the critic's values -------------------------------------------------
    values = [np.concatenate([r["values"] for r in recs
                              if r["rpc"] == "critic_inf"]) for recs in by_step]
    nonzero = [int(np.count_nonzero(v)) for v in values]
    log(f"{tag}: critic_inf values on response tokens: nonzero "
        f"{nonzero} of {[v.size for v in values]} by step, max |v| "
        f"{[float(np.abs(v).max()) for v in values]}")
    if nonzero[0] != 0 or nonzero[-1] == 0 or not all(
            np.isfinite(v).all() for v in values):
        raise AssertionError(f"{tag}: the critic's values are not 0 at step "
                             "1 (its zero head) and then trained")

    # -- logprobs: actor_inf against the generation's ------------------------
    gap = logprob_gap_gate(
        tag, [r for r in mfcs if r["rpc"] == "actor_inf"],
        lambda rec, sid: [rec["version"]] * (max(rec["lens"]) + 1))

    # -- launches --------------------------------------------------------------
    gens = [r for r in mfcs if r["handle"] == "generate"]
    inf_mbs = sum(r.get("n_mbs", 0) for r in mfcs if r["handle"] == "inference")
    train_mbs = sum(r["n_mbs"] for r in mfcs if r["handle"] == "train_step")
    prefills = sum(r["delta"]["prefills"] for r in gens)
    decode_steps = sum(r["delta"]["decode_steps"] for r in gens)
    for r in gens:
        d = r["delta"]
        want_d = ((L * d["decode_steps"], L * d["prefills"], 0) if cuda
                  else (0, 0, 0))
        got_d = (d["decode"], d["fwd"], d["bwd"])
        log(f"{tag}: actor_gen at version {r['version']}: flash_decode / "
            f"flash fwd / bwd launches {got_d} for {d['decode_steps']} decode "
            f"steps and {d['prefills']} prefill (expected {want_d})")
        if got_d != want_d or d["decode_steps"] <= 0 or d["prefills"] != 1:
            raise AssertionError(f"{tag}: actor_gen launches {got_d}, "
                                 f"expected {want_d}")
    splits = []
    for r, marks in zip(gens, timelines):
        rows_s, prefill_s, loop_s = decode_step_split(marks)
        if len(rows_s) != r["delta"]["decode_steps"]:
            raise AssertionError(f"{tag}: {len(rows_s)} decode steps marked, "
                                 f"{r['delta']['decode_steps']} counted")
        splits.append(dict(split_ms=(rows_s.mean(axis=0) * 1e3).tolist(),
                           prefill_s=prefill_s, loop_s=loop_s,
                           elapsed_s=r["elapsed"]))
        log(f"{tag}: actor_gen at version {r['version']}: {r['elapsed']:.3f} "
            f"s, of which the loop {loop_s:.3f} s (prefill with its first "
            f"token and sync {prefill_s:.3f} s; {len(rows_s)} decode steps "
            f"{rows_s[:, 0].sum():.3f} s: {split_line(rows_s)}) and "
            f"{r['elapsed'] - loop_s:.3f} s outside it (the bf16 copy of "
            f"the weights, trimming, the data's host side)")
    want_fa = ((L * (prefills + inf_mbs + 2 * train_mbs), L * train_mbs)
               if cuda else (0, 0))
    got_fa = (fa.fwd_launches, fa.bwd_launches)
    log(f"{tag}: flash launches fwd/bwd {got_fa} for {prefills} prefills, "
        f"{inf_mbs} inference and {train_mbs} train micro-batches (expected "
        f"{want_fa})")
    if got_fa != want_fa:
        raise AssertionError(f"{tag}: flash launches {got_fa}, expected "
                             f"{want_fa}")
    launches = dict(decode=da.flash_decode.launches, fwd=got_fa[0],
                    bwd=got_fa[1], prefill_fwd=L * prefills if cuda else 0)
    del master
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # -- flash_decode at the phase's cache shape -------------------------------
    case = None
    if cuda:
        B, S = loops[0]["B"], loops[0]["cache_len"]
        lengths = [S, 1] + np.random.default_rng(SEED).integers(
            1, S + 1, B - 2).tolist()
        case = flash_decode_case(device, B=B, S=S, lengths=lengths,
                                 timing_iters=50, n_layers=L)
    anat = decode_anatomy(cfg, device, hf_dir, last_loop)
    walls = [st["time_perf/e2e"] for st in hist]
    secs = time.perf_counter() - t_phase
    mfc_s = {m: [round(st[f"{m}/elapsed"], 3) for st in hist]
             for m in want_graph}
    log(f"{tag}: step walls {[round(w, 3) for w in walls]} s; MFC seconds by "
        f"step {mfc_s}; generation {[round(t, 1) for t in gen_tok_s]} "
        f"tokens/s over {decode_steps} decode steps (cache shapes {loops}); "
        f"peak device memory {peak:.2f} GiB; run {run_s:.1f} s, phase "
        f"{secs:.1f} s, on {card}")
    return dict(launches=launches, flash_decode=case, step_s=walls,
                mfc_s=mfc_s, gen_tok_s=gen_tok_s, kl1=kl1, gap=gap,
                peak_gib=peak, run_s=run_s, phase_s=secs,
                decode_steps=decode_steps, loops=loops, splits=splits,
                anatomy=anat)


# -- the training phase: SFT, DPO, the reward model, the options -----------

def training_inputs(tmp, vocab, sft_lens=SFT_LENS):
    """The training phase's data, in ``tmp``: :func:`async_inputs`'
    word-level tokenizer (one token a word), a ``prompt_answer`` jsonl with
    one row per length of ``sft_lens`` (prompt + answer + EOS tokens, the
    prompt a quarter of it) and an ``rw_pair`` jsonl with one row per
    ``(prompt words, ((chosen words, rejected words), ...))`` of
    PAIR_ROWS, the words drawn from numpy seed SEED.  Returns (tokenizer
    dir, SFT path, pairs path)."""
    import numpy as np

    tok_dir, _ = async_inputs(tmp, vocab, rows=1, words=(1, 1), seed=SEED)
    rng = np.random.default_rng(SEED)
    n_words = vocab - 3 - ASYNC_ANSWER_WORDS

    def words(n):
        # a trailing space: the datasets concatenate prompt, answer and EOS
        return "".join(f"w{j} " for j in rng.integers(0, n_words, n))

    sft_path = os.path.join(tmp, "sft.jsonl")
    with open(sft_path, "w") as f:
        for i, n in enumerate(sft_lens):
            p = max(1, n // 4)
            f.write(json.dumps(dict(id=f"s{i}", prompt=words(p),
                                    answer=words(n - p - 1))) + "\n")
    pair_path = os.path.join(tmp, "pairs.jsonl")
    with open(pair_path, "w") as f:
        for i, (p, pairs) in enumerate(PAIR_ROWS):
            prompt = words(p)
            f.write(json.dumps(dict(
                id=f"p{i}", prompt=prompt,
                pos_answers=[words(a) for a, _ in pairs],
                neg_answers=[words(b) for _, b in pairs])) + "\n")
    return tok_dir, sft_path, pair_path


def per_head_plain_attention(q, k, v, seg_ids, window=None):
    """The flash wrapper's plain version (``reference_flash_attention``),
    one query head at a time: its float32 [B, 1, T, T] scores at T = 16384
    take 1 GiB a head instead of 12."""
    import torch

    from areal_tpu_torch.ops.flash_attention import reference_flash_attention

    r = q.shape[2] // k.shape[2]
    return torch.cat([reference_flash_attention(
        q[:, :, h:h + 1], k[:, :, h // r:h // r + 1], v[:, :, h // r:h // r + 1],
        seg_ids, window=window) for h in range(q.shape[2])], dim=2)


def train_route_check(engine, sample, mb_spec, token_key, control):
    """The first micro-batch of a train step, as the engine lays it out,
    through the model's forward three times under ``no_grad``: with the
    flash kernels, with the plain attention (the model's window in it),
    and with a ``control`` that must fail the gates: True, the kernels
    given every row as one segment (a fault that packing shows: a token
    attends to the sequences before it in its row), or ``"no_window"``,
    the plain attention without the model's sliding window (a fault only
    rows longer than the window show); a false one runs none.  Per real token, the relative L2 distance of the final hidden
    state to the plain route's, and, for an actor, |logprob - plain| of
    each transition inside a segment; their maxima for the kernels and
    the control.  The launches here are not counted."""
    import torch

    from areal_tpu_torch.models.transformer import head_weight, hidden_states
    from areal_tpu_torch.ops import flash_attention as fa_mod
    from areal_tpu_torch.ops.loss import per_token_logprobs_entropy

    fa = fa_mod.flash_attention
    c0 = (fa.fwd_launches, fa.bwd_launches)
    mbs, *_ = sample.split(mb_spec)
    batch = engine._device_batch(engine._layout(mbs, token_key)[0])
    params, mcfg = engine.params, engine.model_cfg
    tokens, seg = batch["tokens"], batch["seg_ids"]
    real = seg != 0
    trans = (seg[:, 1:] == seg[:, :-1]) & real[:, 1:]

    def route(flash):
        fa_mod.flash_attention = flash
        try:
            with torch.no_grad():
                h = hidden_states(params, mcfg, tokens, batch["positions"], seg)
                if mcfg.is_critic:
                    return h.float(), None
                B, T, D = h.shape
                lp, _ = per_token_logprobs_entropy(
                    h[:, :-1].reshape(-1, D), head_weight(params, mcfg).to(h.dtype),
                    tokens[:, 1:].reshape(-1), with_entropy=False)
                return h.float(), lp.reshape(B, T - 1)
        finally:
            fa_mod.flash_attention = fa

    h_p, lp_p = route(per_head_plain_attention)
    norm = h_p.norm(dim=-1)[real]

    def distance(h, lp):
        d = dict(hidden=float(((h - h_p).norm(dim=-1)[real] / norm).max()))
        if lp is not None:
            d["logprob"] = float((lp - lp_p).abs()[trans].max())
        return d

    out = dict(kernel=distance(*route(fa)), rows=tuple(tokens.shape),
               segments=int(seg.amax(dim=1).sum()), tokens=int(real.sum()))
    if control is True:
        def wrong(q, k, v, s, window=None):
            return fa(q, k, v, (s != 0).to(s.dtype), window=window)
    elif control == "no_window":
        def wrong(q, k, v, s, window=None):
            return per_head_plain_attention(q, k, v, s)
    elif control:
        raise ValueError(f"unknown control {control!r}")
    if control:
        # the wrapper counts on the module's flash_attention, this function
        # while it stands there
        wrong.fwd_launches = wrong.bwd_launches = 0
        out["control"] = distance(*route(wrong))
    fa.fwd_launches, fa.bwd_launches = c0
    return out


def options_arm(cfg, device):
    """The training options at ``cfg``'s width and OPTIONS_LAYERS layers,
    on one micro-batch of OPTIONS_LENS sequences packed into one row
    (``pack_capacity = sum(OPTIONS_LENS)``): REMAT_STEPS SFT steps from
    the same weights under each remat policy (step 1's gradient norm
    against ``none``'s within TOL_REMAT_GNORM_REL and its loss equal
    within 1e-6; each step's time and peak memory, the first carrying
    first use, such as an offload's pinned host buffers), and two steps
    each of float32 Adam, bf16 ``mu``, bf16 ``nu`` and the factored
    second moment (the first step's lr is the warm-up's 0, so the second
    reads the stored moments): their ``opt_state_bytes``, and the second
    step's parameter change against float32 Adam's (bf16 moments within
    TOL_MOMENT_DELTA relative L2; the factored moment, another
    second-moment estimate with the same signs, at a cosine above
    MIN_FACTORED_COS)."""
    import numpy as np
    import torch

    from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
    from areal_tpu_torch.engine.optimizer import OptimizerConfig, opt_state_bytes
    from areal_tpu_torch.engine.train_engine import TrainEngine, tree_map
    from areal_tpu_torch.interfaces.sft_interface import sft_loss_fn
    from areal_tpu_torch.models.remat import POLICY_NAMES
    from areal_tpu_torch.models.transformer import init_params

    tag = "training/options"
    cfg_l = dataclasses.replace(cfg, n_layers=OPTIONS_LAYERS, remat=True)
    init = init_params(cfg_l, SEED + 1, device, dtype=torch.float32)
    rng = np.random.default_rng(SEED)
    n = int(sum(OPTIONS_LENS))
    pmask = np.concatenate([np.arange(l) < l // 4 for l in OPTIONS_LENS])
    sample = SequenceSample.from_default(
        seqlens=list(OPTIONS_LENS), ids=[f"o{i}" for i in range(len(OPTIONS_LENS))],
        data={"packed_input_ids": rng.integers(
            3, cfg.vocab_size, n).astype(np.int32), "prompt_mask": pmask})

    def run(policy="none", steps=1, **opt_kw):
        torch.cuda.empty_cache()
        eng = TrainEngine(
            dataclasses.replace(cfg_l, remat_policy=policy), None,
            tree_map(lambda t: t.detach().clone(), init),
            OptimizerConfig(lr=OPTIONS_LR, warmup_steps_proportion=0.0,
                            **opt_kw),
            10, device=device, pack_capacity=n)
        sts = []
        for _ in range(steps):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            tik = time.perf_counter()
            st = eng.train_batch(sample, sft_loss_fn,
                                 MicroBatchSpec(max_tokens_per_mb=n))
            torch.cuda.synchronize()
            st["step_s"] = time.perf_counter() - tik
            st["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            st["activation_gib"] = ((torch.cuda.max_memory_allocated() - base)
                                    / 2**30)
            sts.append(st)
        st = dict(sts[0], steps_s=[x["step_s"] for x in sts],
                  activation_gibs=[x["activation_gib"] for x in sts],
                  opt_bytes=opt_state_bytes(eng.opt),
                  delta=[(p.detach() - q).flatten() for p, q in zip(
                      eng._leaves, _leaves(init))])
        st.update(step_s=sts[-1]["step_s"], peak_gib=sts[-1]["peak_gib"])
        del eng
        return st

    run()  # warm-up: the first step's allocations and library handles
    policies = {}
    for policy in POLICY_NAMES:
        st = run(policy, steps=REMAT_STEPS)
        st.pop("delta")
        policies[policy] = st
        log(f"{tag}: remat {policy}: step 1's loss {st['loss']:.6f}, grad "
            f"norm {st['grad_norm']:.6e}; steps "
            f"{[round(s * 1e3, 1) for s in st['steps_s']]} ms, activations "
            f"{[round(g, 2) for g in st['activation_gibs']]} GiB above the "
            f"train state (peak {st['peak_gib']:.2f} GiB)")
    ref = policies["none"]
    for policy, st in policies.items():
        rel = abs(st["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
        if not (math.isfinite(st["loss"]) and rel <= TOL_REMAT_GNORM_REL
                and abs(st["loss"] - ref["loss"]) <= 1e-6 * abs(ref["loss"])):
            raise AssertionError(
                f"{tag}: remat {policy}: loss {st['loss']} grad norm "
                f"{st['grad_norm']} against none's {ref['loss']} "
                f"{ref['grad_norm']} (rel {rel:.2e}, tol "
                f"{TOL_REMAT_GNORM_REL})")
    moments = {}
    for name, kw in (("fp32", {}), ("mu_bf16", dict(mu_dtype="bfloat16")),
                     ("nu_bf16", dict(nu_dtype="bfloat16")),
                     ("factored", dict(factored_second_moment=True))):
        moments[name] = run(steps=2, **kw)
    n_params = sum(t.numel() for t in _leaves(init))
    ref_d = moments["fp32"].pop("delta")
    ref_norm = math.sqrt(sum(float(d.double().square().sum()) for d in ref_d))
    out = {}
    for name, st in moments.items():
        d = st.pop("delta", ref_d)
        diff = math.sqrt(sum(float((a - b).double().square().sum())
                             for a, b in zip(d, ref_d)))
        dot = sum(float((a.double() * b.double()).sum()) for a, b in zip(d, ref_d))
        norm = math.sqrt(sum(float(a.double().square().sum()) for a in d))
        out[name] = dict(opt_bytes=st["opt_bytes"], rel_l2=diff / ref_norm,
                         cos=dot / max(norm * ref_norm, 1e-30),
                         loss=st["loss"], step_s=st["step_s"],
                         peak_gib=st["peak_gib"])
        log(f"{tag}: {name}: opt_state_bytes {st['opt_bytes']} "
            f"({st['opt_bytes'] / 2**30:.3f} GiB); step 2's parameter "
            f"change against float32 Adam's: relative L2 "
            f"{out[name]['rel_l2']:.3e}, cosine {out[name]['cos']:.6f}; "
            f"step {st['step_s'] * 1e3:.1f} ms, peak {st['peak_gib']:.2f} GiB")
    want_bytes = 8 * n_params + 8
    if (out["fp32"]["opt_bytes"] != want_bytes
            or out["mu_bf16"]["opt_bytes"] != want_bytes - 2 * n_params
            or out["nu_bf16"]["opt_bytes"] != want_bytes - 2 * n_params
            or not out["factored"]["opt_bytes"] < want_bytes):
        raise AssertionError(f"{tag}: opt_state_bytes "
                             f"{ {k: v['opt_bytes'] for k, v in out.items()} } "
                             f"for {n_params} parameters")
    for name in ("mu_bf16", "nu_bf16"):
        if not out[name]["rel_l2"] <= TOL_MOMENT_DELTA:
            raise AssertionError(f"{tag}: {name}: parameter change "
                                 f"{out[name]['rel_l2']} from float32 Adam's")
    if not (ref_norm > 0 and out["factored"]["cos"] > MIN_FACTORED_COS):
        raise AssertionError(f"{tag}: factored: cosine {out['factored']['cos']}"
                             f" with float32 Adam's change ({ref_norm})")
    return dict(policies={k: {f: v[f] for f in (
                    "grad_norm", "loss", "steps_s", "peak_gib",
                    "activation_gibs")} for k, v in policies.items()},
                moments=out, n_params=n_params, tokens=n)


def training_phase(cfg, device, card, hf_dir):
    """SFT, DPO and reward-model training through the port's entry points
    on the card, the models from the HF directory ``hf_dir`` at full width
    and depth:

    - ``SFTExperiment`` from the recipe's ``training/configs/sft.yaml``
      (``parse_cli``, as ``python -m areal_tpu_torch.apps.main_sft`` reads
      it; ``mesh_spec=d1``, ``remat: true``, ``max_tokens_per_mb``
      TRAIN_MB_TOKENS) over one batch of SFT_LENS sequences, run twice
      through ``run_experiment_local``: SFT_STEPS steps with rows of the
      longest sequence, then SFT_PACKED_STEPS with the train backend's
      ``pack_capacity`` TRAIN_PACK_CAPACITY.  Gates: finite losses; the
      batch repeats each epoch and step 1's lr is the warm-up's 0, so step
      2's loss repeats step 1's and step 3's must fall below it by more
      than 10x that repeat's difference; the packed run's first loss
      equals the unpadded one's within TOL_SFT_PACKED_REL;
    - ``DPOExperiment`` from ``training/configs/dpo.yaml``: the actor and
      its frozen reference (the actor's abstraction, on an ``inference``
      backend) from ``hf_dir``, one step of DPO_TRAIN_BS prompts; step 1's
      loss within TOL_DPO_LN2 of ln 2 (the actor is its reference: this
      checks the loss's plumbing, not the kernels);
    - ``RMExperiment`` (``rw``): a critic from ``hf_dir`` (a zero value
      head), one step of RW_TRAIN_BS prompts: loss ln 2 within 1e-6 (every
      score 0: plumbing again), a nonzero gradient;
    - :func:`options_arm`.

    The kernels' gate: each run's first train micro-batch through
    :func:`train_route_check`, its final hidden states within
    TOL_TRAIN_HIDDEN and an actor's logprobs within TOL_TRAIN_LOGPROB of
    the plain attention's, and in both SFT runs (rows of several
    sequences) the segment control outside both.  Every run's flash launches against its micro-batches
    (per layer: remat ``none`` 2 forward and 1 backward a train
    micro-batch, an inference micro-batch 1 forward)."""
    import torch

    from areal_tpu_torch.api.cli_args import parse_cli
    from areal_tpu_torch.apps.local_runner import run_experiment_local
    from areal_tpu_torch.base import name_resolve
    from areal_tpu_torch.engine.train_engine import TrainEngine
    from areal_tpu_torch.experiments.dpo_exp import DPOExperiment
    from areal_tpu_torch.experiments.rm_exp import RMExperiment
    from areal_tpu_torch.experiments.sft_exp import SFTExperiment
    from areal_tpu_torch.ops import flash_attention as fa_mod
    from areal_tpu_torch.system import model_worker as mw

    tag = "training"
    t_phase = time.perf_counter()
    L = cfg.n_layers
    fa = fa_mod.flash_attention
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    env0 = {k: os.environ.get(k) for k in ("AREAL_LOG_ROOT", "AREAL_SAVE_ROOT")}
    os.environ["AREAL_LOG_ROOT"] = os.path.join(tmp, "logs")
    os.environ["AREAL_SAVE_ROOT"] = os.path.join(tmp, "save")
    name_resolve.reconfigure("memory")
    configs = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "training", "configs")
    mfcs, failures, originals = [], [], []
    checks = {}

    def patch(owner, name, make):
        orig = getattr(owner, name)
        originals.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def on_rpc(orig):
        def f(self, req):
            spec = req.data
            model = self._models[spec["model_name"]]
            c0 = (fa.fwd_launches, fa.bwd_launches)
            out = orig(self, req)
            rec = dict(run=runs[-1], rpc=spec["rpc_name"],
                       handle=spec["handle_name"],
                       delta=(fa.fwd_launches - c0[0], fa.bwd_launches - c0[1]),
                       elapsed=out.get("elapsed", 0.0))
            try:
                if rec["handle"] == "train_step":
                    rec["stats"] = dict(out["stats"])
                    rec["n_mbs"] = int(out["stats"]["n_mbs"])
                    rec["remat"] = model.model_cfg.remat
                elif rec["handle"] == "inference":
                    rec["n_mbs"] = model.engine.last_forward_mbs
            except Exception as e:  # noqa: BLE001 - raised below
                failures.append(f"{rec['rpc']} record: {e!r}")
            mfcs.append(rec)
            return out
        return f

    def on_train_batch(orig):
        def f(self, sample, loss_fn, mb_spec, token_key="packed_input_ids"):
            name = runs[-1]
            if name not in checks:
                checks[name] = chk = train_route_check(
                    self, sample, mb_spec, token_key,
                    control=name.startswith("sft"))
                log(f"{tag}/{name}: first micro-batch {chk['rows']} "
                    f"({chk['segments']} sequences, {chk['tokens']} tokens) "
                    f"against the plain attention: kernels {chk['kernel']}, "
                    f"rows as one segment {chk.get('control', '-')} (tol "
                    f"hidden {TOL_TRAIN_HIDDEN}, logprob {TOL_TRAIN_LOGPROB})")
            return orig(self, sample, loss_fn, mb_spec, token_key)
        return f

    def within(d):
        return (d["hidden"] <= TOL_TRAIN_HIDDEN
                and d.get("logprob", 0.0) <= TOL_TRAIN_LOGPROB)

    runs = []
    results = {}
    try:
        tok_dir, sft_path, pair_path = training_inputs(tmp, cfg.vocab_size)
        patch(mw.ModelWorker, "_handle_model_rpc", on_rpc)
        patch(TrainEngine, "train_batch", on_train_batch)
        common = [
            "mesh_spec=d1", "experiment_name=chipsmoke",
            f"tokenizer_path={tok_dir}",
            f"dataset.args.max_length={TRAIN_MAX_LENGTH}",
            f"mb_spec.max_tokens_per_mb={TRAIN_MB_TOKENS}",
            "exp_ctrl.save_freq_steps=null", "exp_ctrl.ckpt_freq_steps=null",
        ]
        fa.fwd_launches = fa.bwd_launches = 0
        torch.cuda.reset_peak_memory_stats()

        def run(name, exp_cls, argv, steps, pack=0):
            runs.append(name)
            exp = parse_cli(exp_cls, argv + common + [
                f"trial_name={name.replace('_', '-')}",
                f"exp_ctrl.benchmark_steps={steps}"])
            xcfg = exp.initial_setup()
            if pack:
                for w in xcfg.model_workers:
                    for s in w.shards:
                        if s.backend.type_ == "train":
                            s.backend.args["pack_capacity"] = pack
            torch.cuda.reset_peak_memory_stats()
            tik = time.perf_counter()
            hist = run_experiment_local(xcfg, timeout=900.0).stats_history
            secs = time.perf_counter() - tik
            peak = torch.cuda.max_memory_allocated() / 2**30
            recs = [r for r in mfcs if r["run"] == name]
            log(f"{tag}/{name}: {exp_cls.__name__}, graph "
                f"{[r.name for r in xcfg.master.model_rpcs]}, {len(hist)} "
                f"steps in {secs:.1f} s (model loads included); step walls "
                f"{[round(s['time_perf/e2e'], 3) for s in hist]} s; MFCs "
                f"{[(r['rpc'], r.get('n_mbs'), round(r['elapsed'], 3)) for r in recs]};"
                f" peak device memory {peak:.2f} GiB")
            if len(hist) != steps:
                raise AssertionError(f"{tag}/{name}: {len(hist)} steps, "
                                     f"expected {steps}")
            chk = checks.get(name)
            if chk is None or not within(chk["kernel"]):
                raise AssertionError(f"{tag}/{name}: the kernels against the "
                                     f"plain attention: {chk}")
            results[name] = dict(hist=hist, recs=recs, s=secs, peak_gib=peak)
            return hist, recs

        # -- SFT: rows of the longest sequence, then packed rows -----------
        sft_argv = ["--config", os.path.join(configs, "sft.yaml"),
                    f"model.args.path={hf_dir}",
                    f"dataset.args.dataset_path={sft_path}",
                    f"train_bs_n_seqs={len(SFT_LENS)}",
                    f"optimizer.lr={SFT_LR}",
                    f"exp_ctrl.total_train_epochs={SFT_STEPS}"]
        hist, recs = run("sft", SFTExperiment, sft_argv, SFT_STEPS)
        losses = [s["trainDefault/loss"] for s in hist]
        noise = abs(losses[1] - losses[0])
        fall = losses[0] - losses[2]
        log(f"{tag}/sft: losses {[f'{l:.6f}' for l in losses]}; the batch "
            f"repeats: step 2 - step 1 {-noise:+.3e} (step 1's lr 0), step 3 "
            f"- step 1 {-fall:+.3e}")
        if not all(math.isfinite(l) for l in losses) or not (
                fall > 10 * noise and fall > 0):
            raise AssertionError(f"{tag}/sft: losses {losses}")
        hist_p, _ = run("sft_packed", SFTExperiment,
                        sft_argv[:-1] + ["exp_ctrl.total_train_epochs="
                                         f"{SFT_PACKED_STEPS}"],
                        SFT_PACKED_STEPS, pack=TRAIN_PACK_CAPACITY)
        packed = [s["trainDefault/loss"] for s in hist_p]
        log(f"{tag}/sft_packed: pack_capacity {TRAIN_PACK_CAPACITY}: losses "
            f"{[f'{l:.6f}' for l in packed]} (rows of the longest sequence: "
            f"{[f'{l:.6f}' for l in losses[:len(packed)]]})")
        if not all(math.isfinite(l) for l in packed) or abs(
                packed[0] - losses[0]) > TOL_SFT_PACKED_REL * abs(losses[0]):
            raise AssertionError(f"{tag}/sft_packed: losses {packed} against "
                                 f"{losses}")
        for name in ("sft", "sft_packed"):
            ctl = checks[name]["control"]
            if (ctl["hidden"] <= TOL_TRAIN_HIDDEN
                    or ctl["logprob"] <= TOL_TRAIN_LOGPROB):
                raise AssertionError(f"{tag}/{name}: the segment control "
                                     f"{ctl} passes a gate")

        # -- DPO: the actor and its frozen reference -----------------------
        hist, recs = run("dpo", DPOExperiment, [
            "--config", os.path.join(configs, "dpo.yaml"),
            f"actor.args.path={hf_dir}",
            f"dataset.args.dataset_path={pair_path}",
            f"train_bs_n_seqs={DPO_TRAIN_BS}"], 1)
        d1 = hist[0]["dpo_train/loss"]
        dst = recs[-1]["stats"]
        log(f"{tag}/dpo: step 1's loss {d1:.6f} (ln 2 = {math.log(2):.6f}, "
            f"tol {TOL_DPO_LN2}); {dst['n_tokens']:.0f} pairs, mean margin "
            f"{dst['margin_sum'] / dst['n_tokens']:.4e}, grad norm "
            f"{dst['grad_norm']:.4e}")
        if not abs(d1 - math.log(2)) <= TOL_DPO_LN2:
            raise AssertionError(f"{tag}/dpo: step 1's loss {d1}")

        # -- rw: a critic from the directory -------------------------------
        # no recipe ships a reward-model YAML: the DPO recipe's data and
        # batch settings, a critic of the directory
        rw_yaml = os.path.join(tmp, "rw.yaml")
        with open(rw_yaml, "w") as f:
            json.dump(dict(
                model=dict(type_="hf", args=dict(path=hf_dir, is_critic=True,
                                                 remat=True)),
                dataset=dict(type_="rw_pair", args=dict(
                    dataset_path=pair_path, max_length=TRAIN_MAX_LENGTH,
                    max_pairs_per_prompt=2)),
                train_bs_n_seqs=RW_TRAIN_BS, optimizer=dict(lr=2e-5)), f)
        hist, recs = run("rw", RMExperiment, ["--config", rw_yaml], 1)
        r1 = hist[0]["rw_train/loss"]
        g1 = recs[-1]["stats"]["grad_norm"]
        log(f"{tag}/rw: step 1's loss {r1:.8f} (the zero value head scores "
            f"every sequence 0: ln 2), grad norm {g1:.4e}")
        if not (abs(r1 - math.log(2)) <= 1e-6 and math.isfinite(g1)
                and g1 > 0):
            raise AssertionError(f"{tag}/rw: loss {r1}, grad norm {g1}")
    finally:
        for owner, name, orig in reversed(originals):
            setattr(owner, name, orig)
        for k, v in env0.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    if failures:
        raise AssertionError(f"{tag}: {failures}")

    # -- launches of the experiments ----------------------------------------
    want = [0, 0]
    for r in mfcs:
        per = ((2 if r["remat"] else 1, 1) if r["handle"] == "train_step"
               else (1, 0))
        exp_r = tuple(L * r["n_mbs"] * k for k in per)
        if r["delta"] != exp_r:
            raise AssertionError(f"{tag}/{r['run']}: {r['rpc']} flash "
                                 f"launches {r['delta']} for {r['n_mbs']} "
                                 f"micro-batches, expected {exp_r}")
        want = [a + b for a, b in zip(want, exp_r)]
    got = [fa.fwd_launches, fa.bwd_launches]
    log(f"{tag}: flash launches fwd/bwd {tuple(got)} over the experiments' "
        f"{sum(r['n_mbs'] for r in mfcs)} micro-batches (expected "
        f"{tuple(want)})")
    if got != want:
        raise AssertionError(f"{tag}: flash launches {got}, expected {want}")
    gc.collect()
    torch.cuda.empty_cache()

    # -- the options arm -------------------------------------------------------
    c0 = (fa.fwd_launches, fa.bwd_launches)
    opts = options_arm(cfg, device)
    d_opts = (fa.fwd_launches - c0[0], fa.bwd_launches - c0[1])
    # per layer and step: a policy that recomputes the attention runs the
    # flash forward again in the backward
    fwd_per_step = {"none": 2, "attn_out": 2, "mlp": 2, "qkv_attn": 1,
                    "offload_qkv": 1, "dots": 2}
    # the warm-up and each moment option's 2 steps run remat none
    n_none_steps = 1 + 4 * 2
    want_o = (OPTIONS_LAYERS * (2 * n_none_steps
                                + REMAT_STEPS * sum(fwd_per_step.values())),
              OPTIONS_LAYERS * (n_none_steps + REMAT_STEPS * len(fwd_per_step)))
    log(f"{tag}/options: flash launches fwd/bwd {d_opts} (expected {want_o})")
    if d_opts != want_o:
        raise AssertionError(f"{tag}/options: flash launches {d_opts}, "
                             f"expected {want_o}")
    gc.collect()
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    log(f"{tag}: phase {secs:.1f} s (sft {results['sft']['s']:.1f}, packed "
        f"{results['sft_packed']['s']:.1f}, dpo {results['dpo']['s']:.1f}, rw "
        f"{results['rw']['s']:.1f} s), on {card}")
    return dict(launches=dict(fwd=fa.fwd_launches, bwd=fa.bwd_launches),
                checks=checks, sft_losses=losses, packed_losses=packed,
                dpo=d1, rw=r1, options=opts, phase_s=secs,
                runs={k: dict(s=v["s"], peak_gib=v["peak_gib"],
                              walls=[s["time_perf/e2e"] for s in v["hist"]])
                      for k, v in results.items()})


# -- the family phase: Gemma (head_dim 256) and Mistral (a window) -------


def family_arms():
    """The family phase's arms: (name, HF family, config, SFT lengths,
    route-check control: True for rows as one segment, ``"no_window"``
    for the attention without the window; whether a short generation
    runs)."""
    return [
        dict(name="gemma", family="gemma", cfg=gemma_config(GEMMA_LAYERS),
             lens=GEMMA_SFT_LENS, control=True, generate=False),
        dict(name="mistral", family="mistral",
             cfg=mistral_config(MISTRAL_LAYERS), lens=MISTRAL_SFT_LENS,
             control="no_window", generate=True),
    ]


def window_generation(cfg, master, device, *, prompt_len=WINDOW_GEN_PROMPT,
                      new_tokens=WINDOW_GEN_NEW):
    """One greedy generation of a sliding-window model through sync PPO's
    dense-cache loop (``engine/generation.py generate_loop``: ``prefill``,
    then ``decode_step``, whose card route gathers each layer's window for
    ``flash_decode``) after a prompt longer than the window, on the bf16
    serving copy of ``master``.  Gates: one flash forward launch a layer
    (the prefill, windowed), one ``flash_decode`` launch a layer and
    decode step; the generated tokens' logprobs against the teacher-forced
    windowed forward (the flash kernel) within TOL_WINDOW_MEAN /
    TOL_WINDOW_MAX, and the same tokens against the forward without the
    window, the control, must fail them."""
    import dataclasses

    import numpy as np
    import torch

    from areal_tpu_torch.engine import generation as gen_mod
    from areal_tpu_torch.engine.sampling import SamplingParams
    from areal_tpu_torch.models.convert import serving_params
    from areal_tpu_torch.ops import decode_attention as da
    from areal_tpu_torch.ops import flash_attention as fa_mod

    fa = fa_mod.flash_attention
    params = serving_params(master, cfg)
    (prompt,) = make_prompts(cfg.vocab_size, (prompt_len,), SEED + 95)
    toks = torch.tensor([prompt], dtype=torch.long, device=device)
    lens = torch.tensor([prompt_len], dtype=torch.int32, device=device)
    c0 = (fa.fwd_launches, da.flash_decode.launches)
    gen_mod.counters.decode_steps = 0
    _sync(device)
    tik = time.perf_counter()
    out_t, out_l, n_gen, _ = gen_mod.generate_loop(
        params, cfg, toks, lens, SEED, new_tokens, 0, (),
        SamplingParams(greedy=True), cache_len=prompt_len + new_tokens)
    _sync(device)
    secs = time.perf_counter() - tik
    steps = gen_mod.counters.decode_steps
    got = (fa.fwd_launches - c0[0], da.flash_decode.launches - c0[1])
    want = (cfg.n_layers, cfg.n_layers * steps)
    n = int(n_gen[0])
    served = out_l[0, :n].cpu().numpy()

    def forced(c):
        from types import SimpleNamespace

        out = SimpleNamespace(prompt_ids=prompt,
                              output_ids=out_t[0, :n].tolist())
        return forced_logprobs(params, c, [out])

    gap = _gap(served, forced(cfg))
    gap_global = _gap(served, forced(dataclasses.replace(
        cfg, sliding_window=None)))
    log(f"family/mistral generation: a {prompt_len}-token prompt (window "
        f"{cfg.sliding_window}), {n} greedy tokens in {secs:.2f} s through "
        f"prefill and {steps} decode steps; flash forward / flash_decode "
        f"launches {got} (expected {want})")
    if got != want or n != new_tokens:
        raise AssertionError(f"family/mistral generation: launches {got} "
                             f"(expected {want}), {n} tokens")
    window_tol = (TOL_WINDOW_MEAN, TOL_WINDOW_MAX)
    if not _gap_gate("windowed decode_step against the windowed forward",
                     gap, *window_tol, phase="family"):
        raise AssertionError("the windowed decode step disagrees")
    if _gap_gate("control: the same tokens against the forward without the "
                 "window, which must fail", gap_global, *window_tol,
                 phase="family"):
        raise AssertionError("the window gate cannot tell a window from "
                             "none")
    del params
    return dict(secs=secs, launches=dict(fwd=got[0], decode=got[1]),
                gap=gap, gap_global=gap_global, tokens=n)


def family_phase(device, card, arms=None, *, steps=FAMILY_SFT_STEPS,
                 gen_kw=None):
    """SFT of the families the flash kernel gained last, at their
    published widths, through the port's entry point (``SFTExperiment``
    from ``training/configs/sft.yaml``, ``run_experiment_local``, remat on)
    from an HF directory that the port's own export (``save_hf_model``)
    writes from seeded float32 weights: Gemma-2B (head_dim 256, 8 query
    heads on 1 KV head) and Mistral-7B-v0.1 (window 4096) cut to
    MISTRAL_LAYERS layers, each on one packed row (``pack_capacity`` its
    tokens; Mistral's segments longer than the window), ``steps`` steps.
    Gates per arm: finite losses; the first train micro-batch through
    :func:`train_route_check` within TOL_TRAIN_HIDDEN / TOL_FAMILY_LOGPROB
    of the plain attention, and the arm's control (Gemma: rows as one
    segment; Mistral: the plain attention without the window) outside
    both; the run's flash launches equal to 2 forward and 1 backward a
    layer and micro-batch (remat ``none``).  The Mistral arm first runs
    :func:`window_generation` on the same seeded weights.  Reports each
    arm's export, step walls, peak memory, launches and first loss."""
    import gc

    import torch

    from areal_tpu_torch.api.cli_args import parse_cli
    from areal_tpu_torch.apps.local_runner import run_experiment_local
    from areal_tpu_torch.base import name_resolve
    from areal_tpu_torch.engine.train_engine import TrainEngine
    from areal_tpu_torch.experiments.sft_exp import SFTExperiment
    from areal_tpu_torch.models.hf.registry import save_hf_model
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.ops import flash_attention as fa_mod
    from areal_tpu_torch.system import model_worker as mw

    arms = family_arms() if arms is None else arms
    tag = "family"
    t_phase = time.perf_counter()
    fa = fa_mod.flash_attention
    tmp = tempfile.mkdtemp(prefix="chip_smoke_family_")
    env0 = {k: os.environ.get(k) for k in ("AREAL_LOG_ROOT", "AREAL_SAVE_ROOT")}
    os.environ["AREAL_LOG_ROOT"] = os.path.join(tmp, "logs")
    os.environ["AREAL_SAVE_ROOT"] = os.path.join(tmp, "save")
    name_resolve.reconfigure("memory")
    sft_yaml = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "training", "configs", "sft.yaml")
    originals, mfcs, checks = [], [], {}
    current = {}

    def patch(owner, name, make):
        orig = getattr(owner, name)
        originals.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def on_rpc(orig):
        def f(self, req):
            c0 = (fa.fwd_launches, fa.bwd_launches)
            out = orig(self, req)
            if req.data["handle_name"] == "train_step":
                mfcs.append(dict(
                    arm=current["name"], n_mbs=int(out["stats"]["n_mbs"]),
                    delta=(fa.fwd_launches - c0[0], fa.bwd_launches - c0[1])))
            return out
        return f

    def on_train_batch(orig):
        def f(self, sample, loss_fn, mb_spec, token_key="packed_input_ids"):
            name = current["name"]
            if name not in checks:
                checks[name] = train_route_check(
                    self, sample, mb_spec, token_key,
                    control=current["control"])
            return orig(self, sample, loss_fn, mb_spec, token_key)
        return f

    def within(d):
        return (d["hidden"] <= TOL_TRAIN_HIDDEN
                and d.get("logprob", 0.0) <= TOL_FAMILY_LOGPROB)

    results = {}
    launches = dict(fwd=0, bwd=0, decode=0)
    try:
        patch(mw.ModelWorker, "_handle_model_rpc", on_rpc)
        patch(TrainEngine, "train_batch", on_train_batch)
        for arm in arms:
            name, cfg, lens = arm["name"], arm["cfg"], arm["lens"]
            current.update(name=name, control=arm["control"])
            res = results[name] = {}
            adir = os.path.join(tmp, name)
            master = init_params(cfg, SEED, device, dtype=torch.float32)
            n_params = sum(t.numel() for t in _leaves(master))
            if arm["generate"]:
                res["generation"] = window_generation(cfg, master, device,
                                                      **(gen_kw or {}))
                launches["fwd"] += res["generation"]["launches"]["fwd"]
                launches["decode"] += res["generation"]["launches"]["decode"]
            tik = time.perf_counter()
            save_hf_model(os.path.join(adir, "hf"), arm["family"], cfg,
                          master)
            res["export_s"] = time.perf_counter() - tik
            res["export_bytes"] = _dir_bytes(os.path.join(adir, "hf"))
            del master
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            tok_dir, sft_path, _ = training_inputs(adir, cfg.vocab_size,
                                                   sft_lens=lens)
            pack = sum(lens)
            exp = parse_cli(SFTExperiment, [
                "--config", sft_yaml, "mesh_spec=d1",
                "experiment_name=chipsmoke-family", f"trial_name={name}",
                f"tokenizer_path={tok_dir}",
                f"model.args.path={os.path.join(adir, 'hf')}",
                f"dataset.args.dataset_path={sft_path}",
                f"dataset.args.max_length={max(lens)}",
                f"train_bs_n_seqs={len(lens)}", f"optimizer.lr={SFT_LR}",
                f"mb_spec.max_tokens_per_mb={pack}",
                f"exp_ctrl.total_train_epochs={steps}",
                f"exp_ctrl.benchmark_steps={steps}",
                "exp_ctrl.save_freq_steps=null",
                "exp_ctrl.ckpt_freq_steps=null"]
                + (["force_cpu_devices=1"] if device.type == "cpu" else []))
            xcfg = exp.initial_setup()
            for w in xcfg.model_workers:
                for sh in w.shards:
                    if sh.backend.type_ == "train":
                        sh.backend.args["pack_capacity"] = pack
            c0 = (fa.fwd_launches, fa.bwd_launches)
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            tik = time.perf_counter()
            hist = run_experiment_local(xcfg, timeout=900.0).stats_history
            res["run_s"] = time.perf_counter() - tik
            res["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                               if device.type == "cuda" else 0.0)
            got = (fa.fwd_launches - c0[0], fa.bwd_launches - c0[1])
            recs = [r for r in mfcs if r["arm"] == name]
            want = (sum(2 * cfg.n_layers * r["n_mbs"] for r in recs),
                    sum(cfg.n_layers * r["n_mbs"] for r in recs))
            launches["fwd"] += got[0]
            launches["bwd"] += got[1]
            losses = [h["trainDefault/loss"] for h in hist]
            walls = [h["time_perf/e2e"] for h in hist]
            chk = checks.get(name)
            res.update(losses=losses, walls=walls, launches=got, check=chk,
                       n_params=n_params, layers=cfg.n_layers,
                       tokens=sum(lens))
            log(f"{tag}/{name}: {cfg.n_layers} layers, hidden "
                f"{cfg.hidden_dim}, heads {cfg.n_q_heads}/{cfg.n_kv_heads} "
                f"of {cfg.head_dim}, window {cfg.sliding_window}, vocabulary "
                f"{cfg.vocab_size}: {n_params / 1e9:.3f} B parameters "
                f"(random, seed {SEED}), exported as a {arm['family']} HF "
                f"directory ({res['export_bytes'] / 1e9:.3f} GB float32) in "
                f"{res['export_s']:.1f} s; SFT on one packed row of "
                f"{sum(lens)} tokens (segments {list(lens)}): {len(hist)} "
                f"steps in {res['run_s']:.1f} s (model load included); step "
                f"walls {[round(w, 3) for w in walls]} s; losses "
                f"{[f'{l:.6f}' for l in losses]}; peak device memory "
                f"{res['peak_gib']:.2f} GiB; flash launches fwd/bwd {got} "
                f"(expected {want}); first micro-batch {chk and chk['rows']} "
                f"against the plain attention: kernels "
                f"{chk and chk['kernel']}, control ("
                f"{'segments' if arm['control'] is True else arm['control']}) "
                f"{chk and chk.get('control')} (tol hidden "
                f"{TOL_TRAIN_HIDDEN}, logprob {TOL_FAMILY_LOGPROB}), on {card}")
            if len(hist) != steps or not all(math.isfinite(l)
                                             for l in losses):
                raise AssertionError(f"{tag}/{name}: losses {losses}")
            if got != want:
                raise AssertionError(f"{tag}/{name}: flash launches {got}, "
                                     f"expected {want}")
            if chk is None or not within(chk["kernel"]):
                raise AssertionError(f"{tag}/{name}: the kernels against "
                                     f"the plain attention: {chk}")
            ctl = chk["control"]
            if (ctl["hidden"] <= TOL_TRAIN_HIDDEN
                    or ctl.get("logprob", 1.0) <= TOL_FAMILY_LOGPROB):
                raise AssertionError(f"{tag}/{name}: the control {ctl} "
                                     "passes a gate")
            shutil.rmtree(adir, ignore_errors=True)
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        for owner, attr, orig in reversed(originals):
            setattr(owner, attr, orig)
        for k, v in env0.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    secs = time.perf_counter() - t_phase
    log(f"{tag}: phase {secs:.1f} s ("
        + ", ".join(f"{k}: export {r['export_s']:.1f}, SFT {r['run_s']:.1f}"
                    + (f", generation {r['generation']['secs']:.1f}"
                       if "generation" in r else "")
                    for k, r in results.items())
        + f" s), on {card}")
    return dict(arms=results, launches=launches, phase_s=secs)


# -- the processes phase: one process per worker ---------------------------

#: the processes phase's trial: the recover checkpoint after step 2, the
#: model worker's process killed then, the HF save at step 3
PROC_CKPT_STEP = 2
PROC_SAVE_STEP = 3
#: chunk of a tensor's elements summed at once by :func:`tensor_digest`
DIGEST_CHUNK = 1 << 24


def tensor_digest(t):
    """Two sums over a tensor's bits, as integers: of its elements' bit
    patterns, and of each pattern times its position modulo 65521, plus
    one (both modulo 2**64, so the order of the sums does not matter).
    Tensors of one dtype and shape with equal digests are taken as
    bit-identical; the digest crosses a process boundary as two numbers."""
    import torch

    bits = {4: torch.int32, 2: torch.int16, 1: torch.int8}[t.element_size()]
    flat = t.detach().contiguous().view(-1).view(bits)
    s1 = torch.zeros((), dtype=torch.int64, device=flat.device)
    s2 = torch.zeros((), dtype=torch.int64, device=flat.device)
    for i in range(0, flat.numel(), DIGEST_CHUNK):
        c = flat[i:i + DIGEST_CHUNK].to(torch.int64)
        w = torch.arange(i, i + c.numel(), device=c.device) % 65521 + 1
        s1 += c.sum()
        s2 += (c * w).sum()
    return [str(t.dtype), list(t.shape), int(s1), int(s2)]


def tree_digest(tree):
    """``{"a/b/c": tensor_digest(leaf)}`` over a parameter tree, keyed as
    the port's snapshots key their tensors."""
    from areal_tpu_torch.engine.checkpoint import _flatten

    return {"/".join(kp): tensor_digest(leaf) for kp, leaf in _flatten(tree)}


def file_digest(path, device, like=None):
    """:func:`tree_digest` of every tensor of a safetensors file, read one
    tensor at a time onto ``device``; with ``like`` (a digest), each
    tensor is first cast to the dtype ``like`` names for it, as a restore
    casts a snapshot's leaves to the engine's (a server keeps its norm
    scales in float32 where the snapshot has the model dtype)."""
    import torch
    from safetensors import safe_open

    out = {}
    with safe_open(path, framework="pt", device=str(device)) as f:
        for k in f.keys():
            t = f.get_tensor(k)
            if like is not None and k in like:
                t = t.to(getattr(torch, like[k][0].split(".")[-1]))
            out[k] = tensor_digest(t)
    return out


def _probe_write(rec):
    from areal_tpu_torch.base import constants

    rec = dict(rec, pid=os.getpid(), time=time.time(),
               launch=int(os.environ.get("AREAL_RECOVER") == "1"))
    path = os.path.join(constants.get_log_path(),
                        f"probe.{_PROBE['worker']}.jsonl")
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


_PROBE = {}

#: seconds between two lines of a generation server's counters file
COUNTERS_INTERVAL = 2.0


def kernel_launch_counters():
    """This process's kernel wrappers' launch counters (each wrapper adds
    one where it launches its kernel)."""
    from areal_tpu_torch.ops import decode_attention as da
    from areal_tpu_torch.ops import paged_attention as pa
    from areal_tpu_torch.ops.flash_attention import flash_attention as fa

    std, deep = pa.paged_flash_attention, pa.paged_flash_attention_deep
    return dict(
        paged_std=std.launches, paged_std_int8=std.int8_launches,
        paged_prefill=std.prefill_launches, paged_deep=deep.launches,
        paged_deep_int8=deep.int8_launches, flash_fwd=fa.fwd_launches,
        flash_bwd=fa.bwd_launches, flash_decode=da.flash_decode.launches,
    )


def _counters_write(worker_name, rec):
    """One line of a device process's own counters (its kernel wrappers'
    launches, its peak device memory and ``rec``) appended to
    ``<worker_name>.counters.jsonl`` in the trial's log directory."""
    import torch

    from areal_tpu_torch.base import constants

    peak = (torch.cuda.max_memory_allocated() / 2**30
            if torch.cuda.is_initialized() else 0.0)
    rec = dict(rec, pid=os.getpid(), time=time.time(),
               launches=kernel_launch_counters(), peak_gib=peak)
    path = os.path.join(constants.get_log_path(),
                        f"{worker_name}.counters.jsonl")
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def process_probe(worker_type, worker_index, worker):
    """``AREAL_WORKER_HOOK=chip_smoke:process_probe``: in each worker
    process of the processes phase, wrap the worker's methods as phase 8's
    wrappers do and append what they record, as JSON lines, to
    ``probe.<worker>.jsonl`` in the trial's log directory; the device
    processes also append their own counters to
    ``<worker>.counters.jsonl`` (the model worker after each request that
    ran its model, the server every COUNTERS_INTERVAL seconds and at its
    exit).  A killed process keeps what it wrote."""
    import numpy as np

    _PROBE["worker"] = f"{worker_type}{worker_index}"
    _probe_write(dict(kind="start", worker_type=worker_type))

    def wrap(owner, name, make):
        setattr(owner, name, make(getattr(owner, name)))

    def on_exit(orig):
        def f(self):
            out = orig(self)
            # whether this process ever created a CUDA context
            torch = sys.modules.get("torch")
            _probe_write(dict(kind="exit", cuda=bool(
                torch is not None and torch.cuda.is_initialized())))
            return out
        return f

    wrap(type(worker), "_exit_hook", on_exit)

    if worker_type == "rollout_worker":
        from areal_tpu_torch.system import partial_rollout as pr

        def on_gen_one(orig):
            async def f(self, qid, prompt_ids, root=None, presched=None):
                out = await orig(self, qid, prompt_ids, root=root,
                                 presched=presched)
                _probe_write(dict(kind="member", qid=qid,
                                  versions=list(out.output_versions),
                                  v0=out.version_start, v1=out.version_end))
                return out
            return f

        wrap(pr.PartialRolloutManager, "_gen_one", on_gen_one)
    elif worker_type == "gserver_manager":
        from areal_tpu_torch.observability import get_registry
        from areal_tpu_torch.system import gserver_manager as gm

        def on_update_one(orig):
            def f(self, addr, client, payload, timeout=None):
                tik = time.perf_counter()
                out = orig(self, addr, client, payload, timeout=timeout)
                _probe_write(dict(kind="stage_rpc", version=payload["version"],
                                  mode=payload.get("mode", "full"),
                                  s=time.perf_counter() - tik))
                return out
            return f

        def on_flush(orig):
            def f(self, info):
                tik = time.perf_counter()
                out = orig(self, info)
                _probe_write(dict(
                    kind="swap", version=info["version"],
                    applied=self._model_version,
                    round_s=time.perf_counter() - tik,
                    pause_s=get_registry().gauge(
                        "areal_gserver_weight_update_pause_seconds").value()))
                return out
            return f

        wrap(gm.GserverManager, "_update_one_server", on_update_one)
        wrap(gm.GserverManager, "_flush_and_update", on_flush)
    elif worker_type == "gen_server":
        from areal_tpu_torch.system import generation_server as gs

        def server_counters(self):
            eng = self.engine
            _PROBE["counters_at"] = time.monotonic()
            _counters_write(self.worker_name, dict(
                kind="gen_server", version=eng.version,
                chunk_size=eng.chunk_size, prefill_calls=eng.prefill_calls,
                one_token_fill_calls=eng.one_token_fill_calls,
                decode_chunks_total=eng.decode_chunks_total,
                deep_decode_chunks_total=eng.deep_decode_chunks_total,
                decode_tokens_total=eng.decode_tokens_total,
                gen_tokens_total=eng.gen_tokens_total))

        def on_poll(orig):
            def f(self):
                out = orig(self)
                if (getattr(self, "engine", None) is not None
                        and time.monotonic() - _PROBE.get("counters_at", 0.0)
                        > COUNTERS_INTERVAL):
                    server_counters(self)
                return out
            return f

        def on_exit_hook(orig):
            def f(self):
                eng = getattr(self, "engine", None)
                if eng is not None:
                    server_counters(self)
                    _probe_write(dict(kind="served", version=eng.version,
                                      digest=tree_digest(eng.params)))
                return orig(self)
            return f

        wrap(gs.GenerationServerWorker, "_poll", on_poll)
        wrap(gs.GenerationServerWorker, "_exit_hook", on_exit_hook)
    elif worker_type == "model_worker":
        from areal_tpu_torch.engine import checkpoint
        from areal_tpu_torch.observability import get_registry
        from areal_tpu_torch.system import model_worker as mw

        mbs = {"inference": 0, "train_step": 0}

        def trainer_counters(self):
            # the micro-batches run by kind, against which the flash
            # kernels' launches are checked
            _counters_write(self.worker_name, dict(
                kind="model_worker", mbs=dict(mbs),
                versions={k: m.version.global_step
                          for k, m in self._models.items()},
                engine_versions={k: int(getattr(m.engine, "version", 0))
                                 for k, m in self._models.items()}))

        def state_digest(engine):
            return dict(digest=tree_digest(checkpoint._state_tree(engine)),
                        engine_version=int(engine.version),
                        opt_count=int(engine.opt.count))

        def on_fetch(orig):
            def f(self, batch_size):
                tik = time.perf_counter()
                try:
                    return orig(self, batch_size)
                finally:
                    _probe_write(dict(kind="fetch",
                                      s=time.perf_counter() - tik))
            return f

        def hist_sum(part):
            return get_registry().histogram(
                "areal_weight_publish_seconds").snapshot(part=part)[0]

        def on_publish(orig):
            def f(self, model_name):
                s0 = {p: hist_sum(p) for p in ("full", "int8")}
                tik = time.perf_counter()
                out = orig(self, model_name)
                _probe_write(dict(
                    kind="publish",
                    version=self._models[model_name].version.global_step,
                    host_s=time.perf_counter() - tik,
                    **{p: hist_sum(p) - s0[p] for p in ("full", "int8")}))
                return out
            return f

        def on_rpc(orig):
            def f(self, req):
                if _PROBE.get("held"):
                    # the launcher's kill comes within a poll of the
                    # recover info: no step of this launch runs past it
                    time.sleep(3600)
                spec = req.data
                handle, ids = spec["handle_name"], list(spec["ids"])
                model = self._models[spec["model_name"]]
                rec = dict(kind=handle, version=model.version.global_step,
                           ids=ids)
                if handle == "train_step":
                    v = self._data_manager.get_batch(
                        ids, ["version_start", "version_end"])
                    for k in ("version_start", "version_end"):
                        rec[k] = np.asarray(v.data[k]).reshape(-1).tolist()
                out = orig(self, req)
                if handle in mbs:
                    mbs[handle] += int(
                        model.engine.last_forward_mbs if handle == "inference"
                        else out["stats"]["n_mbs"])
                    trainer_counters(self)
                if handle == "inference":
                    rec["n_mbs"] = model.engine.last_forward_mbs
                    b = self._data_manager.get_batch(ids, [
                        "packed_input_ids", "packed_logprobs", "prompt_mask",
                        "prox_logp"])
                    rec["lens"] = [l[0] for l in b.seqlens["packed_input_ids"]]
                    rec["prompt_mask"] = np.asarray(
                        b.data["prompt_mask"]).astype(int).tolist()
                    rec["behav"] = np.asarray(
                        b.data["packed_logprobs"]).tolist()
                    rec["prox"] = np.asarray(b.data["prox_logp"]).tolist()
                elif handle == "train_step":
                    rec["n_mbs"] = int(out["stats"]["n_mbs"])
                rec["elapsed"] = out.get("elapsed", 0.0)
                _probe_write(rec)
                return out
            return f

        def on_save(orig):
            def f(self, model_name, path):
                tik = time.perf_counter()
                orig(self, model_name, path)
                trainer_counters(self)
                engine = self._models[model_name].engine
                _probe_write(dict(kind="hf_save", path=path,
                                  version=engine.version,
                                  s=time.perf_counter() - tik,
                                  bytes=_dir_bytes(path),
                                  digest=tree_digest(engine.params)))
            return f

        def on_ckpt(orig):
            def f(self, model_name, path):
                tik = time.perf_counter()
                orig(self, model_name, path)
                s = time.perf_counter() - tik
                trainer_counters(self)
                _probe_write(dict(kind="ckpt", path=path, s=s,
                                  bytes=_dir_bytes(path),
                                  **state_digest(
                                      self._models[model_name].engine)))
                kill = os.environ.get("CHIP_SMOKE_KILL_AFTER_STEP")
                if (kill and os.environ.get("AREAL_RECOVER") != "1"
                        and path.endswith(f"globalstep{kill}")):
                    _PROBE["held"] = True
            return f

        def on_recover(orig):
            def f(self, name, backend, model):
                tik = time.perf_counter()
                t_publish = []
                publish = self._publish_weights

                def timed_publish(model_name):
                    t0 = time.perf_counter()
                    publish(model_name)
                    t_publish.append(time.perf_counter() - t0)

                self._publish_weights = timed_publish
                try:
                    orig(self, name, backend, model)
                finally:
                    del self._publish_weights
                if os.environ.get("AREAL_RECOVER") == "1":
                    _probe_write(dict(
                        kind="recover_load",
                        s=time.perf_counter() - tik - sum(t_publish),
                        republish_s=sum(t_publish),
                        step=model.version.global_step,
                        **state_digest(model.engine)))
            return f

        wrap(mw.ModelWorker, "_handle_fetch", on_fetch)
        wrap(mw.ModelWorker, "_publish_weights", on_publish)
        wrap(mw.ModelWorker, "_handle_model_rpc", on_rpc)
        wrap(mw.ModelWorker, "_save_model", on_save)
        wrap(mw.ModelWorker, "_ckpt_model", on_ckpt)
        wrap(mw.ModelWorker, "_maybe_recover_load", on_recover)


def read_jsonl(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def trial_records(log_dir):
    """What the worker processes of a trial left in its log directory:
    ``(stats rows, {worker: counters lines}, {worker: probe lines})``."""
    import glob

    def by_worker(pattern, strip):
        return {os.path.basename(p)[len(strip[0]):-len(strip[1])]:
                read_jsonl(p)
                for p in sorted(glob.glob(os.path.join(log_dir, pattern)))}

    return (read_jsonl(os.path.join(log_dir, "stats.jsonl")),
            by_worker("*.counters.jsonl", ("", ".counters.jsonl")),
            by_worker("probe.*.jsonl", ("probe.", ".jsonl")))


def kill_after_recover_info(step, recover_info, counters, stop, out,
                            poll=0.2):
    """Wait for the master's recover info to resume at ``step`` (its
    checkpoint written), then SIGKILL the model worker's process (the pid
    of the last line of its counters file ``counters``); records the
    time and pid in ``out``.  Returns early once ``stop`` is set."""
    import signal

    while not stop.is_set():
        try:
            with open(recover_info) as f:
                at = json.load(f)["recover_start"]["global_step"]
        except (OSError, ValueError, KeyError):
            at = None
        if at == step:
            pid = read_jsonl(counters)[-1]["pid"]
            out.update(pid=pid, time=time.time())
            os.kill(pid, signal.SIGKILL)
            return
        stop.wait(poll)


def compute_apps():
    """``[(pid, used MiB)]`` of the processes that hold a CUDA context, as
    ``nvidia-smi --query-compute-apps`` lists them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=30)
    out = []
    for line in res.stdout.splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            out.append((int(parts[0]),
                        float(parts[1]) if parts[1].replace(".", "").isdigit()
                        else float("nan")))
    return out


def _last_by_pid(lines):
    """The last line of each process in a counters or probe file, in the
    order the processes started."""
    out = {}
    for line in lines:
        out[line["pid"]] = line
    return out


def processes_phase(cfg, device, card, hf_dir, *, rows=ASYNC_ROWS,
                    prompt_words=ASYNC_PROMPT_WORDS,
                    train_bs=ASYNC_TRAIN_BS, new_tokens=ASYNC_NEW_TOKENS,
                    chunk_tokens=ASYNC_CHUNK_TOKENS,
                    max_tokens_per_mb=MAX_TOKENS_PER_MB, steps=ASYNC_STEPS,
                    ckpt_step=PROC_CKPT_STEP, n_answers=ASYNC_ANSWER_WORDS,
                    timeout=900.0, **exp_kw):
    """Phase 8's experiment as one process per worker, through the port's
    launcher, ``launch_experiment(mode="local", recover_retries=1)``: the
    master, the model worker, the generation server, the gserver manager
    and two rollout workers, each ``python -m areal_tpu_torch.apps.remote``
    (6 processes), with a recover checkpoint at step ``ckpt_step`` and the
    HF save at step ``steps``.  Once the master's recover info resumes at
    ``ckpt_step``, the script SIGKILLs the model worker's process; the
    launcher's restart policy stops every process and launches them all
    again with ``AREAL_RECOVER=1``, and the run resumes at step
    ``ckpt_step + 1`` and ends at ``steps``.

    Each worker process runs :func:`process_probe`
    (``AREAL_WORKER_HOOK``); the gates read across the process boundary:
    the master's ``stats.jsonl`` (the steps, exactly ``steps - ckpt_step``
    after the restart), the device processes' own counters files (their
    kernel wrappers' launches against their engines' work, their versions,
    their peak memory), the probes' lines (token versions, logprobs,
    swaps, checksums of what a process held) and the snapshots and the HF
    save on disk; ``nvidia-smi`` must list no process holding the card
    but this one, the model workers and the servers, and no worker
    process may outlive the phase.  ``exp_kw`` overrides experiment
    fields (CPU rehearsals)."""
    import signal
    import threading
    from pathlib import Path

    import torch

    from areal_tpu_torch.api.config import DatasetAbstraction, ModelAbstraction
    from areal_tpu_torch.api.data import MicroBatchSpec
    from areal_tpu_torch.api.model_api import GenerationHyperparameters
    from areal_tpu_torch.api.system_api import ExperimentSaveEvalControl
    from areal_tpu_torch.apps.main import launch_experiment
    from areal_tpu_torch.base import constants, name_resolve, names
    from areal_tpu_torch.base.recover import RECOVER_INFO_FILE
    from areal_tpu_torch.engine import checkpoint
    from areal_tpu_torch.engine.optimizer import OptimizerConfig
    from areal_tpu_torch.experiments.async_ppo_exp import (
        AsyncPPOMathExperiment,
    )
    from areal_tpu_torch.experiments.ppo_math_exp import PPOHyperparameters
    from areal_tpu_torch.models.hf import load_hf_model

    tag = "processes"
    t_phase = time.perf_counter()
    cuda = device.type == "cuda"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_procs_")
    here = str(Path(__file__).resolve().parent)
    env = dict(
        AREAL_LOG_ROOT=os.path.join(tmp, "logs"),
        AREAL_SAVE_ROOT=os.path.join(tmp, "save"),
        AREAL_CACHE_ROOT=os.path.join(tmp, "cache"),
        AREAL_NAME_RESOLVE="nfs",
        AREAL_NAME_RESOLVE_ROOT=os.path.join(tmp, "name_resolve"),
        AREAL_WORKER_HOOK="chip_smoke:process_probe",
        CHIP_SMOKE_KILL_AFTER_STEP=str(ckpt_step),
        PYTHONPATH=os.pathsep.join(
            p for p in (here, os.environ.get("PYTHONPATH")) if p),
    )
    env0 = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    L = cfg.n_layers
    kill = {}
    stop = threading.Event()
    apps = []  # (time, [(pid, MiB)]) samples of nvidia-smi

    def sample_apps():
        while not stop.wait(5.0):
            try:
                apps.append((time.time(), compute_apps()))
            except (OSError, subprocess.SubprocessError):
                pass

    beats = {}  # worker -> the longest heartbeat age seen

    def sample_beats(worker_names):
        from areal_tpu_torch.system.worker_base import WorkerControlPanel

        panel = WorkerControlPanel(xcfg.experiment_name, xcfg.trial_name)
        while not stop.wait(1.0):
            for w in worker_names:
                try:
                    age = panel.get_heartbeat_age(w)
                except Exception:  # noqa: BLE001 - a key cleared by a launch
                    age = None
                if age is not None:
                    beats[w] = max(beats.get(w, 0.0), age)

    threads = []
    try:
        tok_dir, data_path = async_inputs(tmp, cfg.vocab_size, rows=rows,
                                          words=prompt_words,
                                          n_answers=n_answers)
        exp_args = dict(
            experiment_name="chipsmoke", trial_name="procs",
            n_model_workers=1, force_cpu_devices=None if cuda else 1,
            exp_ctrl=ExperimentSaveEvalControl(
                total_train_epochs=1, benchmark_steps=steps,
                save_freq_steps=steps, ckpt_freq_steps=ckpt_step),
            actor=ModelAbstraction(
                "hf", {"path": hf_dir, "remat": True, "dtype": cfg.dtype}),
            train_bs_n_seqs=train_bs, group_size=16,
            mb_spec=MicroBatchSpec(max_tokens_per_mb=max_tokens_per_mb),
            actor_optimizer=OptimizerConfig(lr=TRAIN_LR,
                                            warmup_steps_proportion=0.0),
            ppo=PPOHyperparameters(
                gen=GenerationHyperparameters(max_new_tokens=new_tokens,
                                              temperature=1.0),
                ppo_n_minibatches=PPO_RECIPE["n_minibatches"],
                kl_ctl=PPO_RECIPE["kl_ctl"],
                disable_value=PPO_RECIPE["disable_value"],
                use_decoupled_loss=PPO_RECIPE["use_decoupled_loss"],
                behav_imp_weight_cap=PPO_RECIPE["behav_imp_weight_cap"]),
            n_rollout_workers=2, n_gen_servers=1,
            max_head_offpolicyness=ASYNC_OFFPOLICYNESS,
            max_concurrent_rollouts=ASYNC_MAX_ROLLOUTS,
            new_tokens_per_chunk=chunk_tokens,
            gen_kv_cache_len=LONG_KV_CACHE_LEN,
            gen_max_concurrent_batch=LONG_MAX_BATCH,
            tokenizer_path=tok_dir,
            dataset=DatasetAbstraction("math_code_prompt", {
                "dataset_path": data_path, "max_length": ASYNC_MAX_LENGTH}),
        )
        exp_args.update(exp_kw)
        xcfg = AsyncPPOMathExperiment(**exp_args).initial_setup()
        constants.set_experiment_trial_names(xcfg.experiment_name,
                                             xcfg.trial_name)
        log_dir = constants.get_log_path()
        recover_dir = constants.get_recover_path()
        realloc_dir = constants.get_param_realloc_path()
        disk = shutil.disk_usage(env["AREAL_SAVE_ROOT"])
        log(f"{tag}: {len(xcfg.rollout_workers) + 4} worker processes "
            f"(master, model worker, generation server, gserver manager, "
            f"{len(xcfg.rollout_workers)} rollout workers) through "
            f"launch_experiment(mode='local', recover_retries=1); phase 8's "
            f"settings, {steps} steps, recover checkpoint at step "
            f"{ckpt_step}, HF save at step {steps}; the save root has "
            f"{disk.free / 1e9:.1f} of {disk.total / 1e9:.1f} GB free")
        if cuda:
            free, total = torch.cuda.mem_get_info()
            log(f"{tag}: device memory before the launch: "
                f"{(total - free) / 2**30:.2f} GiB in use on the card, "
                f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
                f"by this process")
        threads = [threading.Thread(
            target=kill_after_recover_info, name="chip-smoke-kill",
            args=(ckpt_step, os.path.join(recover_dir, RECOVER_INFO_FILE),
                  os.path.join(log_dir, f"{xcfg.model_workers[0].worker_name}"
                               ".counters.jsonl"), stop, kill),
            daemon=True)]
        from areal_tpu_torch.apps.main import _worker_specs

        threads.append(threading.Thread(
            target=sample_beats, daemon=True, name="chip-smoke-beats",
            args=([w for _, _, w in _worker_specs(xcfg)],)))
        if cuda:
            threads.append(threading.Thread(target=sample_apps, daemon=True,
                                            name="chip-smoke-smi"))
        for t in threads:
            t.start()
        tik = time.time()
        launch_experiment(xcfg, mode="local", recover_retries=1,
                          timeout=timeout)
        run_s = time.time() - tik
    finally:
        stop.set()
        for t in threads:
            t.join(30)
        for k, v in env0.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    stats, counters, probes = trial_records(log_dir)
    if not kill:
        raise AssertionError(f"{tag}: the model worker was never killed "
                             f"(no recover info at step {ckpt_step})")
    recs = [r for lines in probes.values() for r in lines]

    def probe(kind, launch=None):
        return [r for r in recs if r["kind"] == kind
                and (launch is None or r["launch"] == launch)]

    starts = probe("start")
    pids = {r["pid"]: r["worker_type"] for r in starts}
    restart = [r for r in stats if r["time"] > kill["time"]]

    # -- the master's steps, before and after the restart -----------------
    for st in stats:
        log(f"{tag}: step {st['step']}{' (resumed)' if st in restart else ''}"
            f": wall {st['time_perf/e2e']:.3f} s, actor_train/loss "
            f"{st['actor_train/loss']:.6e}, kl {st['actor_train/kl']:.3e}, "
            f"reward_mean {st['actor_train/reward_mean']:.4f}, n_tokens "
            f"{st['actor_train/n_tokens']:.0f}, actor_inf "
            f"{st['actor_inf/elapsed']:.3f} s, actor_train "
            f"{st['actor_train/elapsed']:.3f} s, trainer peak "
            f"{st.get('actor_train/device0/hbm_peak_gb', 0.0):.2f} GB")
    if ([st["step"] for st in stats] != list(range(1, steps + 1))
            or [st["step"] for st in restart]
            != list(range(ckpt_step + 1, steps + 1))
            or not all(math.isfinite(st["actor_train/loss"])
                       and "actor_train/kl" in st for st in stats)):
        raise AssertionError(f"{tag}: master steps {stats} (killed at "
                             f"{kill})")

    # -- the recover -------------------------------------------------------
    name_resolve.reconfigure("nfs", record_root=env["AREAL_NAME_RESOLVE_ROOT"])
    try:
        loaded_from = name_resolve.get(names.recover_load(
            xcfg.experiment_name, xcfg.trial_name, "actor@0"))
    finally:
        name_resolve.reconfigure("memory")
    (ckpt,) = [r for r in probe("ckpt", 0)
               if r["path"].endswith(f"globalstep{ckpt_step}")]
    (load,) = probe("recover_load", 1)
    same_state = all(ckpt[k] == load[k] for k in
                     ("digest", "engine_version", "opt_count"))
    first_resumed = min(st["time"] for st in restart)
    restart_s = first_resumed - kill["time"]
    log(f"{tag}: killed the model worker (pid {kill['pid']}) after step "
        f"{ckpt_step}'s recover checkpoint; the restarted model worker "
        f"recorded recover_load {loaded_from} and restored its train state "
        f"(step {load['step']}, engine version {load['engine_version']}, "
        f"AdamW count {load['opt_count']}) with checksums equal to what step "
        f"{ckpt_step} wrote: {same_state}; restart {restart_s:.1f} s from "
        f"the kill to the first resumed step's end; checkpoint "
        f"{ckpt['bytes'] / 1e9:.3f} GB written in {ckpt['s']:.3f} s, read "
        f"in {load['s']:.3f} s, the restored weights republished in "
        f"{load['republish_s']:.3f} s")
    if (not loaded_from.endswith(f"globalstep{ckpt_step}") or not same_state
            or load["step"] != ckpt_step):
        raise AssertionError(f"{tag}: the recover did not restore step "
                             f"{ckpt_step}'s train state")

    # -- swaps and the served version ---------------------------------------
    swaps = probe("swap")
    (served,) = probe("served", 1)
    applied = [s["applied"] for s in swaps if s["launch"] == 1]
    trained = _last_by_pid(next(v for k, v in counters.items()
                                if k.startswith("model_worker")))
    final_trained = list(trained.values())[-1]["versions"]["actor@0"]
    log(f"{tag}: swap rounds {[(s['launch'], s['version'], s['applied'], round(s['pause_s'], 3)) for s in swaps]} "
        f"(launch, version, applied, pause s); the server ended at "
        f"v{served['version']}, the trainer at v{final_trained}")
    if (not applied or served["version"] != max(applied)
            or served["version"] < ckpt_step
            or served["version"] not in (final_trained, final_trained - 1)):
        raise AssertionError(f"{tag}: served v{served['version']}, applied "
                             f"{applied}, trained v{final_trained}")

    # -- staleness and versions per token -------------------------------
    members = {(r["launch"], r["qid"]): r for r in probe("member")}

    def member(rec, sid):
        m = members[(rec["launch"], sid)]
        return m["versions"], m["v0"], m["v1"]

    staleness = token_version_gate(tag, probe("train_step"), member)

    # -- the HF save and the served weights against the files ------------
    (save,) = probe("hf_save")
    with open(os.path.join(save["path"], "config.json")) as f:
        arch = json.load(f)["architectures"]
    tik = time.perf_counter()
    _, reloaded = load_hf_model(save["path"], device=device)
    same_save = tree_digest(reloaded) == save["digest"]
    del reloaded
    t_reload = time.perf_counter() - tik
    snap = os.path.join(realloc_dir, "actor", f"v{served['version']}",
                        checkpoint.TENSORS_NAME)
    on_disk = file_digest(snap, device, like=served["digest"])
    same_served = on_disk == served["digest"]
    if not same_served:
        diff = sorted(k for k in set(on_disk) | set(served["digest"])
                      if on_disk.get(k) != served["digest"].get(k))
        log(f"{tag}: leaves that differ: "
            f"{[(k, on_disk.get(k), served['digest'].get(k)) for k in diff[:4]]}"
            f" ({len(diff)} of {len(on_disk)})")
    log(f"{tag}: the HF save at trainer version {save['version']} "
        f"({save['bytes'] / 1e9:.3f} GB, written in {save['s']:.3f} s) names "
        f"{arch} and reloads ({t_reload:.3f} s) with checksums equal to the "
        f"trainer's final weights: {same_save}; the served v"
        f"{served['version']} tree's checksums equal the published "
        f"snapshot's: {same_served}")
    if arch != ["Qwen2ForCausalLM"] or not same_save or not same_served:
        raise AssertionError(f"{tag}: the HF save or the served weights "
                             "differ from what the trainer wrote")

    # -- logprobs: actor_inf against the behaviour logprobs ---------------
    gap = logprob_gap_gate(tag, probe("inference"),
                           lambda rec, sid: member(rec, sid)[0])

    # -- launches, from each device process's own counters ----------------
    total = dict(std=0, prefill=0, deep=0, fwd=0, bwd=0)
    peaks = {}
    decode_toks = {}
    for worker, lines in counters.items():
        for pid, c in _last_by_pid(lines).items():
            got = c["launches"]
            peaks[f"{worker} (pid {pid})"] = c["peak_gib"]
            if c["kind"] == "model_worker":
                inf = c["mbs"].get("inference", 0)
                tr = c["mbs"].get("train_step", 0)
                want = ((L * inf + 2 * L * tr, L * tr) if cuda else (0, 0))
                have = (got["flash_fwd"], got["flash_bwd"])
                log(f"{tag}: {worker} pid {pid}: flash launches fwd/bwd "
                    f"{have} for {inf} actor_inf and {tr} actor_train "
                    f"micro-batches (expected {want})")
                if have != want:
                    raise AssertionError(f"{tag}: {worker} pid {pid}: flash "
                                         f"launches {have}, expected {want}")
                total["fwd"] += have[0]
                total["bwd"] += have[1]
            else:
                W, fills = c["chunk_size"], c["prefill_calls"]
                one, chunks = c["one_token_fill_calls"], c["decode_chunks_total"]
                deep_chunks = c["deep_decode_chunks_total"]
                have = dict(std=got["paged_std"], deep=got["paged_deep"],
                            prefill=got["paged_prefill"])
                want = (dict(std=L * (fills + W * (chunks - deep_chunks)),
                             deep=L * W * deep_chunks,
                             prefill=L * (fills - one)) if cuda
                        else dict(std=0, deep=0, prefill=0))
                log(f"{tag}: {worker} pid {pid}: {fills} fill chunks ({one} "
                    f"of one token), {chunks} decode chunks ({deep_chunks} "
                    f"deep), {c['decode_tokens_total']} decode tokens; paged "
                    f"launches {have}, expected {want}")
                if (have != want or got["paged_std_int8"]
                        or got["paged_deep_int8"] or (cuda and not have["std"])):
                    raise AssertionError(f"{tag}: {worker} pid {pid}: paged "
                                         f"launches {have}, expected {want}")
                for k in ("std", "deep", "prefill"):
                    total[k] += have[k]
                decode_toks[pid] = c["decode_tokens_total"]

    # -- who held the card, and what is left -------------------------------
    # nvidia-smi may name processes by pids of another namespace (all 1 in
    # a container): the count of contexts is what it can show, and each
    # worker that exits cleanly says whether it created one
    device_pids = {p for p, t in pids.items()
                   if t in ("model_worker", "gen_server")} | {os.getpid()}
    most = max((len(s) for _, s in apps), default=0)
    biggest = max(apps, key=lambda a: sum(m for _, m in a[1]),
                  default=(0, []))[1]
    seen = {p for _, sample in apps for p, _ in sample}
    with_cuda = sorted({pids[r["pid"]] for r in probe("exit") if r["cuda"]})
    log(f"{tag}: nvidia-smi compute apps over {len(apps)} samples: at most "
        f"{most} at once (this script, the model worker and the server "
        f"make 3), pids as listed {sorted(seen)}, the fullest sample "
        f"{biggest} (pid, MiB); workers that exited cleanly with a CUDA "
        f"context: {with_cuda} of {len(probe('exit'))}")
    if cuda and (not apps or most > 3 or with_cuda != ["gen_server",
                                                       "model_worker"]
                 or (seen & set(pids) and not seen <= device_pids)):
        raise AssertionError(f"{tag}: processes other than the model worker "
                             f"and the server held the card: {apps[-3:]}, "
                             f"{with_cuda}")
    alive = []
    for pid in pids:
        try:
            os.kill(pid, 0)
            alive.append(pid)
        except ProcessLookupError:
            pass
    if alive:
        for pid in alive:
            os.kill(pid, signal.SIGKILL)
        raise AssertionError(f"{tag}: worker processes {alive} outlived "
                             "the launch")

    log(f"{tag}: the longest heartbeat gap seen per worker (beats every "
        f"2 s from a daemon thread; the launcher declares a worker lost "
        f"past 60 s): { {w: round(a, 1) for w, a in sorted(beats.items())} } s")

    # -- what it costs -------------------------------------------------------
    fetch = sum(r["s"] for r in probe("fetch"))
    walls = [st["time_perf/e2e"] for st in stats]
    publishes = [(r["launch"], r["version"], round(r["full"], 3),
                  round(r["int8"], 3)) for r in probe("publish")]
    stage_rpcs = [(r["launch"], r["version"], r["mode"], round(r["s"], 3))
                  for r in probe("stage_rpc")]
    secs = time.perf_counter() - t_phase
    res = dict(
        launches=total, step_s=walls, fetch_wait_s=fetch, run_s=run_s,
        restart_s=restart_s, decode_tok_s=sum(decode_toks.values()) / run_s,
        ckpt=dict(bytes=ckpt["bytes"], write_s=ckpt["s"], read_s=load["s"]),
        peaks=peaks, gap=gap, staleness=dict(staleness), phase_s=secs,
        smi_fullest=biggest, heartbeat_gaps=beats)
    log(f"{tag}: step walls {[round(w, 3) for w in walls]} s; actor_train "
        f"{[round(st['actor_train/elapsed'], 3) for st in stats]} s; the "
        f"trainer waited {fetch:.3f} s for data ({fetch / sum(walls):.1%} of "
        f"the step walls); fleet decode {sum(decode_toks.values())} tokens in "
        f"the {run_s:.1f} s run = {res['decode_tok_s']:.1f} tokens/s; publish "
        f"(launch, version, full / int8 host s) {publishes}; stage RPCs "
        f"{stage_rpcs}; pause {[(s['launch'], s['version'], round(s['pause_s'], 3)) for s in swaps]} s; "
        f"restart {restart_s:.1f} s; recover checkpoint {ckpt['bytes'] / 1e9:.3f} "
        f"GB, write {ckpt['s']:.3f} s, read {load['s']:.3f} s; peak device "
        f"memory by process (allocator) "
        f"{ {k: round(v, 2) for k, v in peaks.items()} } GiB; phase "
        f"{secs:.1f} s, on {card}")
    shutil.rmtree(tmp, ignore_errors=True)
    return res


def parent_ab(parent: str):
    """The paged kernels' decode calls (the decode entry, the deep kernel
    on both pools, ``flash_decode``) and the flash-attention forward of the
    parent tree at ``parent`` and of this tree, timed in turns (parent,
    change, change, parent), each side by
    ``areal_tpu_torch/tools/kernel_ab.py`` in its own process from its
    tree's root; prints each side's ``AB`` line."""
    from pathlib import Path

    here = Path(__file__).resolve().parent
    tool = here / "areal_tpu_torch" / "tools" / "kernel_ab.py"
    for tag in ("parent", "change", "change", "parent"):
        tik = time.perf_counter()
        res = subprocess.run(
            [sys.executable, str(tool), tag],
            cwd=str(Path(parent).resolve() if tag == "parent" else here),
            capture_output=True, text=True, timeout=600,
        )
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith("AB ")]
        if res.returncode != 0 or not lines:
            raise AssertionError(f"kernel_ab.py ({tag}) failed:\n"
                                 f"{res.stdout[-2000:]}{res.stderr[-3000:]}")
        log(f"{lines[-1]} ({time.perf_counter() - tik:.1f} s with its build)")


def main() -> int:
    parent = None
    if len(sys.argv) == 3 and sys.argv[1] == "--parent":
        parent = sys.argv[2]
    elif len(sys.argv) != 1:
        print("usage: chip_smoke.py [--parent PATH]", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on a card", file=sys.stderr)
        return 2
    try:
        from areal_tpu_torch.models.config import qwen25_15b_config
        from areal_tpu_torch.models.convert import serving_params
        from areal_tpu_torch.models.hf.registry import load_hf_model
        from areal_tpu_torch.models.transformer import init_params
        from areal_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the areal_tpu_torch package is not importable "
              f"({e}); run from the repository root", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    t_start = tik = time.perf_counter()
    libs = _build.load_libraries(
        "paged_attention", "paged_attention_deep", "flash_attention")
    log(f"build: {len(libs)} libraries in {time.perf_counter() - tik:.1f} s "
        f"(nvcc in parallel, with loading)")
    for lib in libs.values():
        log(f"build: {lib.path.name}: {lib.build_seconds:.1f} s of nvcc")
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"build: {line.strip()}")

    kern = kernel_phase(device)
    decode_dtype_checks(device)
    long_kern = long_kernel_phase(device)
    log(f"kernel phases done at {time.perf_counter() - t_start:.1f} s")

    cfg = qwen25_15b_config()
    tik = time.perf_counter()
    master = init_params(cfg, SEED, device, dtype=torch.float32)
    params = serving_params(master, cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"model: Qwen2.5-1.5B architecture, {cfg.n_layers} layers, "
        f"{n_params / 1e9:.3f} B parameters (random, seed {SEED}; float32 "
        f"master weights and their bf16 serving copy), built in "
        f"{time.perf_counter() - tik:.1f} s")
    # the first CUT_LAYERS layers of both trees (views, not copies)
    cut_cfg = dataclasses.replace(cfg, n_layers=CUT_LAYERS)
    cut_master = dict(master, layers=master["layers"][:CUT_LAYERS])
    cut_params = dict(params, layers=params["layers"][:CUT_LAYERS])
    eng = engine_phase(cfg, params, device, card=card)
    sampled_phase(cfg, params, device)
    chunked_prefill_phase(cfg, params, device)
    anatomy_phase(cfg, params, device)
    log(f"serving phases done at {time.perf_counter() - t_start:.1f} s; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    long = long_context_phase(cut_cfg, cut_master, cut_params, device, card)
    long_launches = {k: dict(launches=r["launches"], int8=r["int8"])
                     for k, r in long.items() if k in ("A", "B", "C")}
    log(f"long-context phase done at {time.perf_counter() - t_start:.1f} s; "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    flash = flash_phase(device)
    log(f"flash phase done at {time.perf_counter() - t_start:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    prefix = {kv: prefix_phase(cut_cfg, cut_master, cut_params, device, card,
                               kv_dtype=kv) for kv in ("auto", "int8")}
    log(f"prefix-cache phase done at {time.perf_counter() - t_start:.1f} s; "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    train = train_phase(cfg, master, params, device, eng["outs"], card)
    log(f"train phase done at {time.perf_counter() - t_start:.1f} s")
    del params, cut_params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    server = server_phase(cut_cfg, cut_master, device, card)
    log(f"server phase done at {time.perf_counter() - t_start:.1f} s; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    hf_root = tempfile.mkdtemp(prefix="chip_smoke_hf_")
    try:
        hf_dir = os.path.join(hf_root, "qwen2")
        hf = hf_phase(cfg, master, device, card, hf_dir)
        log(f"HF phase done at {time.perf_counter() - t_start:.1f} s")
        cut_dir = os.path.join(hf_root, f"qwen2_{CUT_LAYERS}_layers")
        tik = time.perf_counter()
        cut_bytes = write_hf_dir(cut_cfg, cut_master, cut_dir)
        log(f"HF directory of the first {CUT_LAYERS} layers for the sync-PPO "
            f"phase and phases 8 and 9: {cut_bytes / 1e9:.3f} GB in "
            f"{time.perf_counter() - tik:.1f} s")
        tik = time.perf_counter()
        feat_cfg, feat_master = load_hf_model(cut_dir, device=device)
        log(f"features: the {feat_cfg.n_layers}-layer HF directory loaded as "
            f"float32 master weights in {time.perf_counter() - tik:.1f} s")
        features = serving_features_phase(feat_cfg, feat_master, device, card)
        del feat_master
        gc.collect()
        torch.cuda.empty_cache()
        log(f"serving-features phase done at "
            f"{time.perf_counter() - t_start:.1f} s")
        # the loop's trainer and server take the card to themselves
        del master, cut_master, eng["outs"], long
        gc.collect()
        torch.cuda.empty_cache()
        log(f"device memory before the sync-PPO phase: "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        sync = sync_ppo_phase(cut_cfg, device, card, cut_dir)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"sync-PPO phase done at {time.perf_counter() - t_start:.1f} s; "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
            f"after it")
        training = training_phase(cfg, device, card, hf_dir)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"training phase done at {time.perf_counter() - t_start:.1f} s; "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
            f"after it")
        family = family_phase(device, card)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"family phase done at {time.perf_counter() - t_start:.1f} s; "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
            f"after it")
        loop = async_ppo_phase(cut_cfg, device, card, cut_dir,
                               train_bs=LOOP_TRAIN_BS,
                               new_tokens=LOOP_NEW_TOKENS, steps=LOOP_STEPS,
                               offpolicyness=LOOP_OFFPOLICYNESS)
        log(f"async-PPO phase done at {time.perf_counter() - t_start:.1f} s")
        # the worker processes hold the card; this process keeps only its
        # context and what the earlier phases left allocated
        gc.collect()
        torch.cuda.empty_cache()
        procs = processes_phase(cut_cfg, device, card, cut_dir,
                                train_bs=PROC_TRAIN_BS,
                                new_tokens=PROC_NEW_TOKENS)
    finally:
        shutil.rmtree(hf_root, ignore_errors=True)
    log(f"processes phase done at {time.perf_counter() - t_start:.1f} s")

    entries = kernel_entries(kern, long_kern, eng, long_launches, flash,
                             train, prefix, server, hf, sync, training, loop,
                             procs, features, family)
    if parent is not None:
        torch.cuda.empty_cache()
        parent_ab(parent)
    # a thread that outlives its phase would hold the interpreter's exit
    lingering = _lingering_threads()
    if lingering:
        raise AssertionError(f"threads still running after the phases: "
                             f"{lingering}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card_line())
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def kernel_entries(kern, long_kern, eng, long, flash, train, prefix, server,
                   hf, sync, training, loop, procs, features, family):
    """The ``{"kernels": [...]}`` line's entries: every kernel, with its
    launches on the main paths (the engine's greedy wave, the long-context
    arms, the prefix-cache phase, the generation server, the server that
    swapped in the HF directory and the async-PPO loop; sync PPO's
    generation for ``flash_decode``; the trainer's steps, sync PPO's, the
    training phase's (SFT, DPO, rw and the options arm, remat recomputes
    included), the family phase's SFT of Gemma and Mistral, its windowed
    generation, and the loop's for the flash kernels), its comparison's
    largest absolute error, and its time, plain time and bound at its
    main-path shape (the flash kernels also at head_dim 256 and with a
    window)."""
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "shape")

    def entry(name, source, replaces, launches, err, main, **extra):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches, max_abs_err=err,
                    library_ms=main.get("library_ms"),
                    **{k: main[k] for k in timed}, **extra)

    paged_src = "areal_tpu_torch/csrc/paged_attention.cu"
    deep_src = "areal_tpu_torch/csrc/paged_attention_deep.cu"
    paged_ref = "areal_tpu/ops/paged_attention.py:201"
    deep_ref = "areal_tpu/ops/paged_attention.py:463"

    def arm_launches(kind, int8):
        return sum(r["launches"][kind] for r in long.values()
                   if r["int8"] == int8)

    def errs(*keys, src=kern):
        return max(src[k]["max_abs_err"] for k in keys)

    fp_prefix, int8_prefix = (prefix[k]["launches"] for k in ("auto", "int8"))
    feat_fp, feat_i8 = (features["launches"][k] for k in ("fp", "int8"))
    entries = [
        entry("paged_flash_attention", paged_src, paged_ref,
              eng["launches"] + arm_launches("std", False) + fp_prefix["std"]
              + server["launches"]["std"] + hf["launches"]["std"]
              + loop["launches"]["std"] + procs["launches"]["std"]
              + feat_fp["std"],
              max(errs("decode", "prefill", "prefill_long",
                       "prefill_mid_page", "verify"),
                  errs("standard_bf16", src=long_kern)),
              kern["decode"],
              launches_by_path=dict(
                  engine_wave=eng["launches"],
                  long_context=arm_launches("std", False),
                  prefix_cache=fp_prefix["std"],
                  generation_server=server["launches"]["std"],
                  hf_swap=hf["launches"]["std"],
                  async_ppo=loop["launches"]["std"],
                  async_ppo_processes=procs["launches"]["std"],
                  serving_features=feat_fp["std"]),
              prefill_entry_launches=(eng["prefill_launches"]
                                      + arm_launches("prefill", False)
                                      + fp_prefix["prefill"]
                                      + server["launches"]["prefill"]
                                      + hf["launches"]["prefill"]
                                      + loop["launches"]["prefill"]
                                      + procs["launches"]["prefill"]
                                      + feat_fp["prefill"]),
              verify_window_launches=feat_fp["verify"],
              prefill={k: kern["prefill"][k] for k in timed},
              prefill_long={k: kern["prefill_long"][k] for k in timed},
              prefill_mid_page={k: kern["prefill_mid_page"][k]
                                for k in timed},
              verify={k: kern["verify"][k] for k in timed},
              long_decode={k: long_kern["standard_bf16"][k] for k in timed}),
        entry("paged_flash_attention_int8", paged_src,
              "areal_tpu/ops/paged_attention.py:116",
              arm_launches("std", True) + int8_prefix["std"] + feat_i8["std"],
              max(errs("int8_decode", "int8_prefill", "int8_prefill_long",
                       "int8_prefill_mid_page", "int8_verify"),
                  errs("standard_int8", src=long_kern)),
              long_kern["standard_int8"],
              launches_by_path=dict(long_context=arm_launches("std", True),
                                    prefix_cache=int8_prefix["std"],
                                    serving_features=feat_i8["std"]),
              prefill_entry_launches=(arm_launches("prefill", True)
                                      + int8_prefix["prefill"]
                                      + feat_i8["prefill"]),
              decode={k: kern["int8_decode"][k] for k in timed},
              prefill={k: kern["int8_prefill"][k] for k in timed},
              prefill_long={k: kern["int8_prefill_long"][k] for k in timed},
              prefill_mid_page={k: kern["int8_prefill_mid_page"][k]
                                for k in timed},
              verify={k: kern["int8_verify"][k] for k in timed}),
        entry("paged_flash_attention_deep", deep_src, deep_ref,
              arm_launches("deep", False),
              max(errs("deep_prefill", "deep_decode"),
                  errs("deep_bf16", src=long_kern)),
              long_kern["deep_bf16"],
              decode={k: kern["deep_decode"][k] for k in timed},
              prefill={k: kern["deep_prefill"][k] for k in timed}),
        entry("paged_flash_attention_deep_int8", deep_src, deep_ref,
              arm_launches("deep", True),
              max(errs("deep_int8_prefill", "deep_int8_decode"),
                  errs("deep_int8", src=long_kern)),
              long_kern["deep_int8"],
              decode={k: kern["deep_int8_decode"][k] for k in timed},
              prefill={k: kern["deep_int8_prefill"][k] for k in timed}),
        entry("flash_decode", deep_src, "areal_tpu/ops/decode_attention.py:150",
              sync["launches"]["decode"] + features["launches"]["flash_decode"]
              + family["launches"]["decode"],
              max(long_kern["flash_decode"]["max_abs_err"],
                  sync["flash_decode"]["max_abs_err"]),
              sync["flash_decode"],
              launches_by_path=dict(
                  sync_ppo=sync["launches"]["decode"],
                  dense_serving=features["launches"]["flash_decode"],
                  window_decode_step=family["launches"]["decode"]),
              long={k: long_kern["flash_decode"][k]
                    for k in timed + ("library_ms",)},
              note="library_ms is scaled_dot_product_attention on the same "
                   "full rows"),
    ]
    feat_fa = dict(fwd=features["launches"]["flash_fwd"], bwd=0)
    shape_keys = ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                  "library_ms", "sdpa_kernels")
    for kind in ("fwd", "bwd"):
        main_shape, long_shape = flash["packed"][kind], flash["long"][kind]
        entries.append(dict(
            name=f"flash_attention_{kind}",
            route="cuda",
            source="areal_tpu_torch/csrc/flash_attention.cu",
            replaces="areal_tpu/ops/flash_attention.py:36",
            launches=(train["launches"][kind] + sync["launches"][kind]
                      + training["launches"][kind] + loop["launches"][kind]
                      + procs["launches"][kind] + feat_fa[kind]
                      + family["launches"][kind]),
            launches_by_path=dict(train=train["launches"][kind],
                                  sync_ppo=sync["launches"][kind],
                                  training=training["launches"][kind],
                                  async_ppo=loop["launches"][kind],
                                  async_ppo_processes=procs["launches"][kind],
                                  dense_serving=feat_fa[kind],
                                  family_phase=family["launches"][kind]),
            max_abs_err=max(r[kind]["max_abs_err"] for r in flash.values()),
            **{k: main_shape[k] for k in shape_keys},
            long={k: long_shape[k] for k in shape_keys},
            **{name: {k: flash[name][kind][k] for k in shape_keys}
               for name in ("hd256_packed", "hd256_long", "window_long")},
            **({"parts_ms": main_shape["parts_ms"],
                "long_parts_ms": long_shape["parts_ms"],
                **{f"{name}_parts_ms": flash[name][kind]["parts_ms"]
                   for name in ("hd256_packed", "hd256_long",
                                "window_long")}}
               if kind == "bwd" else {}),
        ))
    return entries


def _perturbed(params, seed):
    """``params`` with every layer's MLP output projection moved by noise of
    its own scale (the other leaves are shared, not copied)."""
    import torch

    out = dict(params, layers=[])
    for lp in params["layers"]:
        w = lp["mlp"]["down"]["w"]
        g = torch.Generator(device=w.device)
        g.manual_seed(seed)
        noise = torch.randn(w.shape, generator=g, device=w.device)
        down = dict(lp["mlp"]["down"], w=(w.float() + noise * w.float().std()).to(w.dtype))
        out["layers"].append(dict(lp, mlp=dict(lp["mlp"], down=down)))
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _lingering_threads():
    import threading

    return [t.name for t in threading.enumerate()
            if t is not threading.main_thread() and not t.daemon
            and t.is_alive()]


if __name__ == "__main__":
    import multiprocessing
    import traceback

    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    # a failed phase may leave worker threads and their ZMQ sockets alive,
    # which would hold the interpreter's exit: name them, stop the child
    # processes (the verifier's pool) and end the process without joining
    # the threads, as a failure
    lingering = _lingering_threads()
    if lingering:
        print(f"chip_smoke: threads still running at exit: {lingering}",
              file=sys.stderr)
        for proc in multiprocessing.active_children():
            proc.terminate()
            proc.join(10)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code or 1)
    sys.exit(code)
