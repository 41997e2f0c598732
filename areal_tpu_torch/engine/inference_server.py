"""Continuous-batching inference engine over a paged KV pool or a dense
per-row cache, with interruptible weight update (port of
``areal_tpu/engine/inference_server.py``'s ``ContinuousBatchingEngine``).

Design, as in the reference:

* One shared block pool ``[L, NB, Hkv, BS, hd]`` and per-row block tables;
  capacity is allocated in ``page_size``-token pages as rows grow, and a
  host allocator keeps a refcount per block.
* Each :meth:`ContinuousBatchingEngine.step` admits pending requests into
  free rows, prefills prompts in ``prefill_chunk_tokens`` chunks
  (:func:`~areal_tpu_torch.models.paged.paged_fill_chunk`), dispatches a
  ``chunk_size``-token decode chunk for every live row
  (:func:`~areal_tpu_torch.models.paged.paged_decode_chunk`) into a
  ``pipeline_depth``-deep ring of in-flight chunks, and harvests the
  oldest chunk once the ring is full.  A chunk's outputs start a
  non-blocking copy to pinned host memory at dispatch, with a CUDA event
  recorded behind it; the harvest waits on that event only, so the host
  never synchronises the stream inside a chunk.
* A sampling group's prompt is prefilled once: members that arrive while
  it fills join the fill, share its full blocks by reference and get a
  copy of its partial tail block.
* A radix prefix cache (:mod:`~areal_tpu_torch.engine.prefix_cache`)
  indexes the blocks of completed prompts and finished or parked
  sequences, so any request whose prefix is cached (a retry, the next
  turn of a conversation, a group member arriving late) pins that prefix
  and prefills only its suffix.
* A row that stops at its token budget without EOS PARKS: its KV stays
  resident, and a continuation under the same qid whose prompt is the
  row's tokens resumes decoding with no prefill.
* Under pool pressure, allocation reclaims in tiers: prefix-cache entries,
  then parked rows (longest parked first), then it preempts the youngest
  decoding row, which re-admits later through a fill (recomputing the
  part of its prefix the cache no longer holds).
* ``update_weights(params)`` takes effect between chunks: the ring is
  drained, parked rows are released, the cache is flushed, the weights
  swap, and every in-flight row's KV is recomputed under the new weights.
* A staged swap splits that in two: ``stage_weights`` makes the serving
  copy on the device (on a side CUDA stream, from any thread) while decode
  goes on, and ``commit_staged`` hands it to the next step's apply, which
  is then a pointer flip.  A stage whose version is not newer than the
  served one is dropped.  Every output token carries the version it was
  sampled under.
* ``pause``/``resume`` quiesce the loop (a paused step only drains the
  ring); ``cancel`` releases a request wherever it lives.
* With ``slo_tracking`` (the default) each request gets a latency record:
  admission wait, time to first token, time per output token and the
  time it stalled in weight swaps and preemptions, folded into
  mergeable percentile digests (:mod:`areal_tpu_torch.observability.latency`).
* Sampling is keyed on (engine seed, request seed, absolute position), so
  token streams do not depend on chunk size, pipeline depth, row
  placement, sharing or preemption.
* A :class:`~areal_tpu_torch.engine.dispatch.PagedDispatchTable` resolves
  ``cache_mode="auto"`` and routes a decode chunk to the deep paged
  kernel once the batch's longest live context reaches its
  ``deep_min_context``.
* ``kv_cache_dtype="int8"`` stores the pool as int8 with float32 scales
  per (block, head, slot); fill and decode chunks quantize at the scatter,
  both kernels dequantize at the read, and block copies carry the scales.
* ``serving_weight_dtype="int8"`` keeps every matmul weight as int8 with a
  float32 scale per output channel (``models/quantize.py``), quantized at
  construction and at every weight swap, dequantized at use in each
  projection.
* ``prefix_cache_host_bytes > 0`` adds the prefix cache's host tier:
  evicted full blocks are copied to host memory instead of dropped, and a
  match on them restores them (one batched scatter), the admission
  requeued until the step after.
* ``spec_decode_params`` (paged and greedy only) turns on self-speculative
  decoding (``engine/spec_decode.py``): rows draft their continuations by
  n-gram lookup and one batched verify window per step scores the drafts,
  token-identical to plain greedy decode.
* ``cache_mode="dense"`` (and ``"auto"`` below the dispatch table's
  ``paged_min_cache_len``, or for a sliding-window model) keeps one
  ``[L, max_batch, Hkv, kv_cache_len, hd]`` cache: a batched prefill per
  admission wave, group prompts prefilled once, and decode chunks of
  ``models/transformer.py decode_chunk``, whose main-cache attention is
  the ``flash_decode`` kernel on a card.

Left out so far, each rejected explicitly where a caller could ask for it:
P/D handoff and fleet prefix pulls (ROADMAP.md queue 1, item 8), token
streams (item 11), tensor-parallel meshes (item 10), MoE models, and the
HBM ledger.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import zlib
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from areal_tpu_torch.api import model_api
from areal_tpu_torch.base import logging_
from areal_tpu_torch.base.device import DeviceLike, resolve_device
from areal_tpu_torch.engine import spec_decode
from areal_tpu_torch.engine.batching import bucket_len, spec_window_bucket
from areal_tpu_torch.engine.checkpoint import LeafSpec
from areal_tpu_torch.engine.dispatch import PagedDispatchTable
from areal_tpu_torch.engine.prefix_cache import PrefixMatch, RadixPrefixCache
from areal_tpu_torch.engine.sampling import SamplingParams, sample_logits_keyed
from areal_tpu_torch.models import paged, quantize
from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.models.convert import serving_dtype, serving_params
from areal_tpu_torch.models.transformer import KVCache, decode_chunk, prefill
from areal_tpu_torch.observability.latency import LatencyDigest, LatencyRecord
from areal_tpu_torch.observability.tracing import get_tracer

logger = logging_.getLogger("inference_server")

#: numpy types of the engine's device state tensors
_NP = {torch.int32: np.int32, torch.bool: np.bool_}


def _qid_seed(qid: str) -> int:
    """Per-request sampler-key identity: deterministic across processes and
    unique per request."""
    return zlib.crc32(qid.encode()) & 0x7FFFFFFF


def _not_ported(what: str, item: Optional[int] = None) -> NotImplementedError:
    """The error for what the port does not do yet; ``item`` names the
    entry of ROADMAP.md's queue 1 that will port it."""
    where = f"ROADMAP.md queue 1, item {item}" if item else "ROADMAP.md"
    return NotImplementedError(
        f"{what} is not ported to areal_tpu_torch yet (see {where})"
    )


@dataclasses.dataclass
class _Row:
    """Host-side state of one in-flight request."""

    req: model_api.APIGenerateInput
    prompt: List[int]
    generated: List[int]
    logprobs: List[float]
    version_start: int
    no_eos: bool = False
    cur_token: int = -1  # pending token (its KV is not in the pool yet)
    budget_left: int = 0  # host-side view of remaining new-token budget
    # row reserved while its prompt prefills chunk by chunk
    filling: bool = False
    # a PARKED row finished its budget without EOS and keeps its KV
    # resident, so a continuation under its qid resumes with no prefill;
    # the parking clock counts engine steps
    parked: bool = False
    park_step: int = 0
    # bumped on every admission and resume: a pipelined chunk's harvest
    # touches only the occupant its dispatch snapshotted
    epoch: int = 0
    # the weight version each generated token was sampled under
    versions: List[int] = dataclasses.field(default_factory=list)
    # speculative decoding: the row's n-gram index and acceptance EMA,
    # made when it first drafts; it survives park, resume, preemption and
    # swaps (none of them rewrites history)
    spec: Optional[spec_decode.SpecRowState] = None
    # SLO stamps (monotonic clock; telemetry only, no dispatch decision
    # reads them): submit -> admit is the admission wait, submit -> first
    # token the TTFT, (last - first) / (tokens - 1) the TPOT; stall_s sums
    # weight-swap pauses and time spent preempted while in flight
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_last: float = 0.0
    slo_stall_s: float = 0.0
    t_preempt: float = 0.0


@dataclasses.dataclass
class _FillTarget:
    """One consumer of an in-progress fill: a fresh request (its first
    token is sampled when the fill completes) or a preempted row resuming
    after its re-prefill (``resume`` carries its host state)."""

    row_id: int
    req: Optional[model_api.APIGenerateInput]
    max_new: int
    resume: Optional[_Row] = None


@dataclasses.dataclass
class _Fill:
    """An in-progress chunked prefill of ONE token sequence into the
    canonical ``blocks``.  Requests arriving with the same prompt while it
    fills become extra ``targets`` and share its blocks when it completes.
    ``fill_pos`` starts past a cached prefix.  A weight-swap recompute has
    no targets and samples nothing."""

    key: Tuple[int, ...]
    tokens: List[int]
    blocks: List[int]
    targets: List[_FillTarget]
    fill_pos: int = 0


@dataclasses.dataclass
class _InflightChunk:
    """One dispatched-but-unharvested decode chunk: its outputs
    ``(out_t, out_l, emitted, active)`` as host tensors being filled by
    a non-blocking copy, the event recorded behind that copy (None on the
    CPU), and the dispatch-time ``(row_id, epoch)`` occupancy.
    ``spec_meta`` marks a speculative verify chunk, ``{row_id: (qid,
    n_drafted)}`` for its drafting rows: it folds in like a decode chunk
    and drives the acceptance bookkeeping at harvest."""

    host: Tuple[torch.Tensor, ...]
    ready: Optional[torch.cuda.Event]
    snapshot: List[Tuple[int, int]]
    spec_meta: Optional[Dict[int, Tuple[str, int]]] = None


@torch.no_grad()
def _admit_rows(
    params,
    cfg: TransformerConfig,
    cache: KVCache,
    tokens: torch.Tensor,  # [m, T] right-padded UNIQUE prompts
    lengths: torch.Tensor,  # [m] int32
    rows: torch.Tensor,  # [n] target cache rows
    src: torch.Tensor,  # [n] which unique prompt each target row copies
    seeds: torch.Tensor,  # [n] per-request sampler key identity
    seed: int,
    sampling: SamplingParams,
):
    """The dense cache's batched prefill: the ``m`` unique prompts run
    through the model once, in a cache of their own, and each prompt's KV
    is copied into every target row that shares it (a sampling group of n
    pays one prefill); each target samples its own first token, keyed on
    (request seed, prompt length).  Writes ``cache`` in place and returns
    (tokens [n] int32, logprobs [n] f32)."""
    m, T = tokens.shape
    dev = tokens.device
    positions = torch.arange(T, device=dev)[None, :].expand(m, T)
    seg = (positions < lengths[:, None]).to(torch.int32)
    mini = KVCache.zeros(cfg, m, T, device=dev)
    logits, mini = prefill(
        params, cfg, tokens, positions, seg, mini,
        last_pos=torch.clamp(lengths - 1, min=0),
    )
    cache.k[:, rows, :, :T] = mini.k[:, src]
    cache.v[:, rows, :, :T] = mini.v[:, src]
    cache.lengths[rows] = lengths[src]
    return sample_logits_keyed(
        logits[:, 0][src].float(), seed, seeds, lengths[src], sampling
    )


class ContinuousBatchingEngine:
    """Thread-safe continuous-batching generation on one device."""

    def __init__(
        self,
        cfg: TransformerConfig,
        params,
        max_batch: int = 32,
        kv_cache_len: int = 4096,
        chunk_size: int = 16,
        sampling: Optional[SamplingParams] = None,
        stop_tokens: Sequence[int] = (),
        seed: int = 0,
        device: DeviceLike = None,
        cache_mode: str = "auto",
        page_size: int = 1024,
        kv_pool_tokens: Optional[int] = None,
        kv_cache_dtype: str = "auto",
        serving_weight_dtype: str = "auto",
        prefill_chunk_tokens: int = 1024,
        pipeline_depth: int = 2,
        dispatch_table: Optional[PagedDispatchTable] = None,
        prefix_cache: bool = True,
        prefix_cache_capacity_frac: float = 0.5,
        prefix_cache_min_tokens: int = 1,
        prefix_cache_host_bytes: int = 0,
        spec_decode_params=None,
        slo_tracking: bool = True,
        handoff_streaming: bool = False,
        mesh=None,
        server_name: str = "",
        tokenizer=None,
    ):
        """Arguments mirror the reference engine's.  ``device`` defaults to
        ``cuda``; pass ``"cpu"`` to run on the CPU.  ``params`` is the port's
        parameter dictionary (:func:`~areal_tpu_torch.models.transformer.
        init_params`, or a reference tree through
        :func:`~areal_tpu_torch.models.convert.params_from_jax`), of which
        the engine keeps a copy in the serving types.

        ``pipeline_depth`` is the most decode chunks dispatched but not yet
        harvested: K=1 dispatches and then harvests at once, K=2 overlaps a
        chunk's output copy with the next chunk's device time.  Token
        streams are identical across K.

        ``kv_pool_tokens`` sizes the pool (default: the dense equivalent
        ``max_batch * kv_cache_len``; at least one full-length row).  A
        smaller pool serves by reclaiming cache entries and parked rows and
        by preempting decoding rows.

        ``prefix_cache`` keeps the radix index over completed prompts and
        finished or parked sequences; it may hold references to
        ``prefix_cache_capacity_frac`` of the pool, and matches shorter
        than ``prefix_cache_min_tokens`` are not used.  Its entries are the
        first thing reclaimed for a live row, and a weight swap flushes it.
        ``prefix_cache_host_bytes > 0`` adds its host tier: evicted full
        blocks spill to up to that many bytes of host memory (counted at
        the pool's real block size, scales included) and are restored when
        a match reaches them.

        ``cache_mode`` is ``"paged"``, ``"dense"`` or ``"auto"``, which
        consults ``dispatch_table`` (default: paged from 2048 tokens, deep
        kernel never) by ``kv_cache_len``; a sliding-window model resolves
        to the dense cache, the only one that serves it.  The same table
        picks the deep paged kernel for a decode chunk by the batch's
        longest live context.  ``kv_cache_dtype`` is ``"auto"``
        (model-dtype pool) or ``"int8"`` (int8 pool with float32 scales;
        a dense cache serves at the model dtype, with a warning).
        ``serving_weight_dtype="int8"`` serves int8 matmul weights with
        per-output-channel scales, quantized from the tree given here and
        from every swapped-in full-precision tree.

        ``spec_decode_params`` (:class:`~areal_tpu_torch.engine.spec_decode.
        SpecDecodeParams`) turns on self-speculative decoding on a paged,
        greedy engine; elsewhere it is disabled with a warning, as in the
        reference.

        ``slo_tracking`` keeps a latency record per request (see
        :meth:`slo_stats`); ``server_name`` labels them.  A ``tokenizer``'s
        EOS token joins ``stop_tokens``.

        Refused with ``NotImplementedError``: ``handoff_streaming=True``
        (P/D handoff, ROADMAP.md queue 1, item 8) and ``mesh`` (item
        10)."""
        if cache_mode not in ("auto", "dense", "paged"):
            raise ValueError(f"unknown cache_mode {cache_mode!r}")
        self.dispatch_table = dispatch_table or PagedDispatchTable()
        self.paged = cache_mode == "paged" or (
            cache_mode == "auto"
            and kv_cache_len >= self.dispatch_table.paged_min_cache_len
            and cfg.sliding_window is None
        )
        if self.paged and cfg.sliding_window is not None:
            raise ValueError(
                "the paged cache serves global-attention models; a "
                f"sliding-window model (sliding_window={cfg.sliding_window}) "
                "takes the dense cache (cache_mode='dense' or 'auto')"
            )
        if kv_cache_dtype not in ("auto", "int8"):
            raise ValueError(
                f"kv_cache_dtype must be 'auto' or 'int8', got {kv_cache_dtype!r}"
            )
        if kv_cache_dtype == "int8" and not self.paged:
            logger.warning(
                "kv_cache_dtype='int8' asked for, but the cache mode resolved "
                "to dense; the int8 pool is paged only: serving at the model "
                "dtype"
            )
            kv_cache_dtype = "auto"
        if serving_weight_dtype not in ("auto", "int8"):
            raise ValueError(
                "serving_weight_dtype must be 'auto' or 'int8', got "
                f"{serving_weight_dtype!r}"
            )
        if handoff_streaming:
            raise _not_ported("streamed P/D KV handoff (handoff_streaming=True)",
                              item=8)
        if mesh is not None:
            raise _not_ported("tensor-parallel serving (mesh)", item=10)
        if pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.serving_weight_dtype = serving_weight_dtype
        self._weight_quant = serving_weight_dtype == "int8"
        # quality counters of int8 serving weights: parity harnesses fold
        # their greedy divergence checks in here
        self.weight_quant_divergence_checks_total = 0
        self.weight_quant_divergence_diverged_total = 0
        # an int8 engine's restore template for a full-precision snapshot
        # (a publisher that wrote no int8 tree): shapes and serving dtypes
        # on the engine's device, no data; the restored tree is quantized
        # on arrival, so the resident format never changes
        self._full_weight_template = (
            _spec_tree(params, cfg, self.device) if self._weight_quant
            else None
        )
        self.params = self._serving_copy(params)
        self.max_batch = max_batch
        self.kv_cache_len = kv_cache_len
        self.chunk_size = chunk_size
        self.pipeline_depth = pipeline_depth
        self.sampling = sampling or SamplingParams()
        stop = set(stop_tokens)
        if tokenizer is not None and tokenizer.eos_token_id is not None:
            stop.add(int(tokenizer.eos_token_id))
        self.stop_tokens = tuple(sorted(stop))
        self.seed = seed
        self.version = 0
        self.kv_cache_dtype = kv_cache_dtype
        self._kv_quant = kv_cache_dtype == "int8"
        # quality counters of the int8 pool: parity harnesses fold their
        # greedy divergence checks in here
        self.kv_quant_divergence_checks_total = 0
        self.kv_quant_divergence_diverged_total = 0

        # speculative decoding: the paged path, under greedy sampling only
        self._spec: Optional[spec_decode.SpecDecodeParams] = None
        if spec_decode_params is not None and spec_decode_params.enabled:
            if not self.paged:
                logger.warning(
                    "spec_decode asked for, but the cache mode resolved to "
                    "dense; speculative decoding runs on the paged path "
                    "only: disabled"
                )
            elif not self.sampling.greedy:
                logger.warning(
                    "spec_decode asked for with non-greedy sampling; draft "
                    "verification is exact under greedy decode only: "
                    "disabled"
                )
            else:
                self._spec = spec_decode_params
        self.spec_drafted_total = 0
        self.spec_accepted_total = 0
        self.spec_rejected_total = 0
        self.spec_verify_chunks_total = 0
        self.spec_fallback_rows_total = 0
        # (row, verify) participations with drafts: the unit of tokens
        # emitted per verify pass
        self.spec_draft_row_passes_total = 0
        # recent per-verify acceptance fractions, drained by the server
        self._spec_accept_samples: Deque[float] = deque(maxlen=1024)

        # host-tier rounds (one batched gather per spill round, one batched
        # scatter per restore) and their bytes and host seconds
        self.host_spill_rounds_total = 0
        self.host_restore_rounds_total = 0
        self.host_spill_bytes_total = 0
        self.host_restore_bytes_total = 0
        self.host_restore_seconds_total = 0.0
        self._filling: List[_Fill] = []
        self._preempted: List[_Row] = []
        self._prefix_cache: Optional[RadixPrefixCache] = None
        if self.paged:
            self._init_paged_state(page_size, kv_pool_tokens,
                                   prefill_chunk_tokens)
            if prefix_cache:
                host_bytes = max(0, int(prefix_cache_host_bytes))
                self._prefix_cache = RadixPrefixCache(
                    page_size=self.page_size,
                    capacity_blocks=int(
                        prefix_cache_capacity_frac * self.n_blocks
                    ),
                    acquire=self._incref_blocks,
                    release=self._free_block_list,
                    min_match_tokens=prefix_cache_min_tokens,
                    host_bytes_budget=host_bytes,
                    block_bytes=self._pool_block_bytes(),
                    spill_fetch=self._spill_gather if host_bytes > 0 else None,
                )
        else:
            dev = self.device
            self.cache = KVCache.zeros(cfg, max_batch, kv_cache_len, dev)
            self.cur_tokens = torch.zeros(max_batch, dtype=torch.int32,
                                          device=dev)
            self.active = torch.zeros(max_batch, dtype=torch.bool, device=dev)
            self.budgets = torch.zeros(max_batch, dtype=torch.int32,
                                       device=dev)
            self.row_seeds = torch.zeros(max_batch, dtype=torch.int32,
                                         device=dev)

        self.rows: List[Optional[_Row]] = [None] * max_batch
        self._pending: List[model_api.APIGenerateInput] = []
        self._results: Dict[str, model_api.APIGenerateOutput] = {}
        self._result_events: Dict[str, threading.Event] = {}
        self._lock = threading.Lock()
        # pending swap, one atomic cell: (params, target_version | None,
        # pre_sharded).  pre_sharded marks a staged tree, already the
        # engine's serving copy on its device: the apply is a pointer flip
        self._new_params: Optional[Tuple[Any, Optional[int], bool]] = None
        self._staged_params = None
        self._staged_version: Optional[int] = None
        self._stage_stream = None  # side CUDA stream of the staged copies
        self._paused = threading.Event()
        # weight-swap time (cumulative seconds): stage = making a staged
        # copy while decode went on; pause = the apply, which does
        # interrupt decode (ring drain, flip or copy, cache flush, recompute)
        self.swap_stage_s = 0.0
        self.swap_pause_s = 0.0
        self.swaps_total = 0
        self.swaps_staged_total = 0
        self.tracer = get_tracer()
        self.mesh_devices = 1
        # request-level SLO plane: records and digests (host telemetry:
        # a few clock stamps per request, nothing on the per-token path)
        self._slo_enabled = bool(slo_tracking)
        self.server_name = server_name
        self.slo_records_total = 0
        self._submit_ts: Dict[str, float] = {}
        self._slo_records: Deque[LatencyRecord] = deque(maxlen=4096)
        self._slo_digests: Dict[str, LatencyDigest] = {
            "admission_wait_s": LatencyDigest(),
            "ttft_s": LatencyDigest(),
            "tpot_s": LatencyDigest(),
            "stall_s": LatencyDigest(),
        }
        self.cancelled_total = 0
        # cancels of rows caught mid-fill, retried after each step's fills
        self._cancel_wanted: set = set()
        self.gen_tokens_total = 0
        self.park_ttl_steps = 512  # engine steps a parked row may idle
        # True: decode only, admit nothing (drain-before-update servers)
        self.hold_admissions = False
        self._step_seq = 0  # deterministic clock, one tick per step()
        self._epoch_counter = 0
        self._ring: Deque[_InflightChunk] = deque()
        # work counters: fill chunks (each runs the paged kernel once per
        # layer: its prefill entry, or its decode entry when the chunk's
        # widest row is one token), decode chunks (once per layer and
        # step; deep chunks through the deep kernel), tokens prefilled and
        # generated, blocks copied, continuations resumed, rows preempted
        self.prefill_calls = 0
        self.one_token_fill_calls = 0
        self.prefill_tokens_total = 0
        self.decode_chunks_total = 0
        self.deep_decode_chunks_total = 0
        self.decode_tokens_total = 0  # tokens folded in from decode chunks
        self.decode_steps_total = 0  # decode steps enqueued (chunk x steps)
        self.block_copies_total = 0
        self.resumed_total = 0
        self.preempted_total = 0
        # fills given back to free blocks for a decoding row
        self.aborted_fills_total = 0
        # preemptions by the victim's priority class
        self.preempted_by_class: Dict[str, int] = {}

    # -- paged-cache state ----------------------------------------------------

    def _init_paged_state(
        self,
        page_size: int,
        kv_pool_tokens: Optional[int],
        prefill_chunk_tokens: int,
    ):
        cfg, max_batch, dev = self.cfg, self.max_batch, self.device
        BS = page_size
        self.page_size = BS
        self.blocks_per_row = -(-self.kv_cache_len // BS)  # MB
        pool_tokens = kv_pool_tokens or max_batch * self.kv_cache_len
        # one full-length row always fits
        self.n_blocks = max(-(-pool_tokens // BS), self.blocks_per_row)
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.k_pool, self.v_pool, self.k_scale, self.v_scale = (
            paged.alloc_kv_pool(
                cfg, self.n_blocks, BS, dev, kv_cache_dtype=self.kv_cache_dtype
            )
        )
        self.kv_pool_bytes, self.kv_scale_bytes = paged.kv_pool_layout_bytes(
            cfg, self.n_blocks, BS, kv_cache_dtype=self.kv_cache_dtype
        )
        self.kv_lengths = torch.zeros(max_batch, dtype=torch.int32, device=dev)
        self.cur_tokens = torch.zeros(max_batch, dtype=torch.int32, device=dev)
        self.active = torch.zeros(max_batch, dtype=torch.bool, device=dev)
        self.budgets = torch.zeros(max_batch, dtype=torch.int32, device=dev)
        # per-request sampler key identity of each row's occupant
        self.row_seeds = torch.zeros(max_batch, dtype=torch.int32, device=dev)
        self._tables_np = np.zeros((max_batch, self.blocks_per_row), np.int32)
        self._tables = self._to_device(self._tables_np)
        self._tables_dirty = False
        # host allocator: LIFO free stack + refcounts (shared prompt
        # blocks, cache references)
        self._free_blocks = list(range(self.n_blocks - 1, -1, -1))
        self._block_ref = np.zeros((self.n_blocks,), np.int32)
        self._row_blocks: List[List[int]] = [[] for _ in range(max_batch)]

    # -- host <-> device ------------------------------------------------------

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without synchronising the stream
        (a pageable copy would): pinned staging + non-blocking copy."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    def _set_rows(self, name: str, ids, vals):
        """``self.<name>[ids] = vals`` on the device state."""
        t = getattr(self, name)
        t[self._to_device(np.asarray(ids, np.int64))] = self._to_device(
            np.asarray(vals, _NP[t.dtype])
        )

    # -- block allocator -------------------------------------------------------

    def _alloc_blocks(self, n: int) -> Optional[List[int]]:
        if len(self._free_blocks) < n:
            return None
        out = [self._free_blocks.pop() for _ in range(n)]
        for b in out:
            self._block_ref[b] = 1
        return out

    def _incref_blocks(self, blocks: List[int]):
        for b in blocks:
            self._block_ref[b] += 1

    def _free_block_list(self, blocks: List[int]):
        for b in blocks:
            self._block_ref[b] -= 1
            if self._block_ref[b] < 0:
                raise RuntimeError(f"double free of pool block {b}")
            if self._block_ref[b] == 0:
                self._free_blocks.append(b)

    def _alloc_blocks_reclaiming(
        self, n: int, keep_qids=(), protect_step: Optional[int] = None
    ) -> Optional[List[int]]:
        """``_alloc_blocks`` with tiered reclamation: prefix-cache entries
        first (recompute insurance: the cache always yields to live rows;
        with the host tier on, yielding means spilling), then parked rows,
        except those whose continuation is queued (``keep_qids``).  None
        when both tiers are exhausted (the caller may then preempt or
        requeue).  ``protect_step`` spares cache nodes touched at that
        step (a restore allocates while the nodes it restores sit freshly
        matched)."""
        blocks = self._alloc_blocks(n)
        while blocks is None:
            deficit = n - len(self._free_blocks)
            if self._prefix_cache is not None and self._prefix_cache.evict(
                deficit, protect_step=protect_step
            ):
                pass
            elif self._evict_parked(keep_qids=keep_qids) is None:
                return None
            blocks = self._alloc_blocks(n)
        return blocks

    def _set_row_blocks(self, row_id: int, blocks: List[int]):
        self._row_blocks[row_id] = blocks
        t = self._tables_np[row_id]
        t[:] = 0
        t[: len(blocks)] = blocks
        self._tables_dirty = True

    def _release_row(self, row_id: int):
        """Single exit point for a row slot: frees its pool blocks."""
        self.rows[row_id] = None
        if self.paged and self._row_blocks[row_id]:
            self._free_block_list(self._row_blocks[row_id])
            self._set_row_blocks(row_id, [])

    def _copy_pool_blocks(self, src: List[int], dst: List[int]):
        """Copy-on-write block copies (group tails, prefix-cache tail
        matches); an int8 pool carries the scale slices with the bytes.
        Enqueued on the stream before any fill that reads the copies."""
        paged.copy_blocks(
            self.k_pool, self.v_pool,
            self._to_device(np.asarray(src, np.int64)),
            self._to_device(np.asarray(dst, np.int64)),
            self.k_scale, self.v_scale,
        )
        self.block_copies_total += len(src)

    def _pool_block_bytes(self) -> int:
        """One pool block's storage bytes, from the pool tensors (an int8
        pool's bytes plus its float32 scales): the host tier's unit."""
        parts = paged._pool_parts(self.k_pool, self.v_pool, self.k_scale,
                                  self.v_scale)
        return sum(p.numel() * p.element_size() for p in parts) // max(
            self.n_blocks, 1
        )

    def _spill_gather(self, blocks: List[int]):
        """The prefix cache's ``spill_fetch``: whole blocks to host memory
        in one batch (an int8 pool's bytes with their scales)."""
        out = paged.gather_blocks_host(
            self.k_pool, self.v_pool, blocks, self.k_scale, self.v_scale
        )
        self.host_spill_rounds_total += 1
        self.host_spill_bytes_total += sum(
            a.numel() * a.element_size() for a in out
        )
        return out

    def _scatter_host_payloads(self, payloads, blocks: List[int]):
        """One batched restore of per-block host payloads into ``blocks``,
        enqueued on the stream behind the work already there."""
        paged.restore_blocks_from_host(
            self.k_pool, self.v_pool, payloads, blocks, self.k_scale,
            self.v_scale,
        )
        self.host_restore_bytes_total += sum(
            a.numel() * a.element_size() for p in payloads for a in p
        )

    def _restore_spilled(self, nodes, keep_qids=()) -> bool:
        """Bring spilled prefix blocks back into the pool: allocate blocks
        (reclamation spares the nodes being restored), enqueue one batched
        scatter of their payloads, and make the nodes usable from the next
        engine step (the admission requeues meanwhile).  False when the
        pool cannot provide the blocks: the caller uses the resident part
        of the match."""
        tik = time.perf_counter()
        blocks = self._alloc_blocks_reclaiming(
            len(nodes), keep_qids=keep_qids, protect_step=self._step_seq
        )
        if blocks is None:
            return False
        payloads = self._prefix_cache.begin_restore(nodes)
        self._scatter_host_payloads(payloads, blocks)
        self._prefix_cache.complete_restore(
            nodes, blocks, ready_step=self._step_seq + 1
        )
        self.host_restore_rounds_total += 1
        self.host_restore_seconds_total += time.perf_counter() - tik
        return True

    @property
    def free_pool_blocks(self) -> int:
        return len(self._free_blocks)

    def note_kv_divergence_check(self, checked: int, diverged: int):
        """Fold a measured greedy-divergence check (an int8 arm compared
        with an fp arm token by token) into the engine's cumulative
        quality counters."""
        self.kv_quant_divergence_checks_total += int(checked)
        self.kv_quant_divergence_diverged_total += int(diverged)

    def kv_quant_stats(self) -> Dict[str, int]:
        """Quantized-KV storage counters."""
        held = self.n_blocks - len(self._free_blocks) if self._kv_quant else 0
        store = self.k_pool if self.paged else self.cache.k
        return {
            "quantized": int(self._kv_quant),
            "storage_bits": store.element_size() * 8,
            "quantized_blocks_held": int(held),
            "divergence_checks_total": self.kv_quant_divergence_checks_total,
            "divergence_diverged_total": (
                self.kv_quant_divergence_diverged_total
            ),
        }

    def note_weight_divergence_check(self, checked: int, diverged: int):
        """Fold a measured greedy-divergence check (an int8-weight arm
        compared with a full-precision arm token by token) into the
        engine's cumulative quality counters."""
        self.weight_quant_divergence_checks_total += int(checked)
        self.weight_quant_divergence_diverged_total += int(diverged)

    def weight_quant_stats(self) -> Dict[str, int]:
        """Serving-weight counters: the resident format, its storage bits,
        the quantized projections, the tree's bytes and the divergence
        checks."""
        quantized = quantize.is_quantized_tree(self.params)
        if quantized:
            bits = quantize.STORAGE_BITS
        else:
            probe = self.params["layers"][0]["attn"]["q"]["w"]
            bits = probe.element_size() * 8
        return {
            "quantized": int(quantized),
            "storage_bits": bits,
            # counted as in the reference's layer-stacked tree (one
            # layer's projections), so the gauge reads the same in both
            "quantized_leaves": quantize.quantized_leaf_count(
                dict(self.params, layers=self.params["layers"][:1])
            ),
            "param_bytes": quantize.tree_bytes(self.params),
            "divergence_checks_total": self.weight_quant_divergence_checks_total,
            "divergence_diverged_total": (
                self.weight_quant_divergence_diverged_total
            ),
        }

    # -- cross-request prefix cache ---------------------------------------------

    def _cache_insert(self, seq: List[int], blocks: List[int]):
        """Register ``seq``'s KV-bearing blocks in the radix cache (full
        blocks by reference, the partial tail by value)."""
        if self._prefix_cache is None or not seq or not blocks:
            return
        self._prefix_cache.insert(
            seq, blocks, step=self._step_seq, version=self.version
        )

    def _match_prefix(self, seq: List[int]) -> PrefixMatch:
        # record=False: a requeued admission re-matches every step until the
        # pool can serve it; _new_fill counts the match once, when used
        if self._prefix_cache is None or len(seq) < 2:
            return PrefixMatch()
        return self._prefix_cache.match(seq, step=self._step_seq, record=False)

    def _new_fill(self, seq: List[int], keep_qids=()) -> Optional[_Fill]:
        """A ``_Fill`` for ``seq`` reusing the longest cached prefix: the
        matched full blocks are PINNED (shared by reference), a matched
        partial tail is copied into an owned block (the donor may still
        append to it), and ``fill_pos`` starts past the cached prefix.
        None when the pool cannot provide the other blocks even after
        reclamation (the caller requeues), or when the match reached
        host-tier blocks: their restore is dispatched (or already pending)
        and the requeued admission matches them resident next step."""
        n_blocks = max(1, -(-len(seq) // self.page_size))
        m = self._match_prefix(seq)
        if m.restore_nodes or m.pending:
            restored = bool(m.restore_nodes) and self._restore_spilled(
                m.restore_nodes, keep_qids=keep_qids
            )
            if restored or m.pending:
                return None
            # the pool could not take the restore: fall back to the
            # resident part of the match, which must clear the floor alone
            if m.n_tokens < self._prefix_cache.min_match_tokens:
                m = PrefixMatch()
        # pin what the match returned BEFORE allocating: the allocation may
        # evict cache entries, and an unpinned matched block could be
        # recycled into this very allocation
        pinned = list(m.blocks)
        if m.tail_block is not None:
            pinned.append(m.tail_block)
        self._incref_blocks(pinned)
        blocks = self._alloc_blocks_reclaiming(
            n_blocks - len(m.blocks), keep_qids=keep_qids
        )
        if blocks is None:
            self._free_block_list(pinned)
            return None
        if self._prefix_cache is not None and len(seq) >= 2:
            self._prefix_cache.record(m)
        if m.tail_block is not None:
            # the tail's first tail_tokens slots are valid; the whole block
            # is copied and the suffix fill overwrites the rest
            self._copy_pool_blocks([m.tail_block], [blocks[0]])
            self._free_block_list([m.tail_block])  # copy taken: unpin
        return _Fill(
            key=tuple(seq),
            tokens=list(seq),
            blocks=list(m.blocks) + blocks,
            targets=[],
            fill_pos=m.n_tokens,
        )

    def prefix_cache_stats(self) -> Dict[str, int]:
        if self._prefix_cache is None:
            return RadixPrefixCache.zero_stats()
        return self._prefix_cache.stats()

    # -- public API --------------------------------------------------------------

    def submit(self, req: model_api.APIGenerateInput) -> str:
        if (req.metadata or {}).get("stream"):
            raise _not_ported("token streaming (metadata['stream'])", item=11)
        if (req.metadata or {}).get("handoff_to"):
            raise _not_ported("P/D KV handoff (metadata['handoff_to'])", item=8)
        with self._lock:
            self._pending.append(req)
            self._result_events[req.qid] = threading.Event()
            if self._slo_enabled:
                self._submit_ts[req.qid] = time.monotonic()
        return req.qid

    # -- request-level SLO plane ----------------------------------------------

    def _slo_admitted(self, row: _Row, now: Optional[float] = None):
        """Stamp a row's submit and admit times, wherever a request binds
        to a row: a fill admission or a park-resume."""
        if not self._slo_enabled:
            return
        now = time.monotonic() if now is None else now
        with self._lock:
            t0 = self._submit_ts.pop(row.req.qid, now)
        row.t_submit = t0
        row.t_admit = now
        row.t_first = row.t_last = 0.0
        row.slo_stall_s = 0.0
        row.t_preempt = 0.0

    def _slo_first_token(self, row: _Row, now: Optional[float] = None):
        if not self._slo_enabled or row.t_first:
            return
        row.t_first = row.t_last = time.monotonic() if now is None else now

    def _slo_finish(self, row: _Row):
        """Fold a finished (or parked: each answer is a completed request
        for its client) row into the records and digests."""
        if not self._slo_enabled:
            return
        with self._lock:
            self._submit_ts.pop(row.req.qid, None)
        tokens = len(row.generated)
        if row.t_admit == 0.0 or row.t_first == 0.0 or tokens == 0:
            return  # never admitted, or produced nothing
        md = row.req.metadata or {}
        ttft = max(0.0, row.t_first - row.t_submit)
        tpot = (
            max(0.0, row.t_last - row.t_first) / (tokens - 1)
            if tokens >= 2
            else None
        )
        sched = md.get("slo_schedule_wait_s")
        rec = LatencyRecord(
            qid=row.req.qid,
            workload=str(md.get("workload", "rollout")),
            server=self.server_name,
            mesh_devices=self.mesh_devices,
            schedule_wait_s=(
                float(sched) if isinstance(sched, (int, float)) else None
            ),
            admission_wait_s=max(0.0, row.t_admit - row.t_submit),
            ttft_s=ttft,
            tpot_s=tpot,
            stall_s=row.slo_stall_s,
            tokens=tokens,
        )
        self._slo_records.append(rec)
        self.slo_records_total += 1
        d = self._slo_digests
        d["admission_wait_s"].observe(rec.admission_wait_s)
        d["ttft_s"].observe(ttft)
        d["stall_s"].observe(rec.stall_s)
        if tpot is not None:
            d["tpot_s"].observe(tpot)

    def drain_slo_records(self) -> List[LatencyRecord]:
        """Pop the recent per-request latency records (the server feeds
        them into the ``areal_slo_*`` registry histograms)."""
        out = list(self._slo_records)
        self._slo_records.clear()
        return out

    def slo_stats(self) -> Dict[str, Any]:
        """Percentile summary of the engine's digests."""
        return {
            "records_total": self.slo_records_total,
            **{k: d.percentiles() for k, d in self._slo_digests.items()},
        }

    def slo_digests(self) -> Dict[str, Dict[str, Any]]:
        """The digests' raw, mergeable state."""
        return {k: d.to_dict() for k, d in self._slo_digests.items()}

    def wait_result(
        self, qid: str, timeout: float = 600.0
    ) -> model_api.APIGenerateOutput:
        ev = self._result_events.get(qid)
        if ev is None:
            raise KeyError(f"unknown qid {qid}")
        if not ev.wait(timeout):
            raise TimeoutError(f"generation {qid} timed out")
        with self._lock:
            self._result_events.pop(qid, None)
            return self._results.pop(qid)

    def try_get_result(self, qid: str) -> Optional[model_api.APIGenerateOutput]:
        """Non-blocking result fetch."""
        with self._lock:
            if qid in self._results:
                self._result_events.pop(qid, None)
                return self._results.pop(qid)
        return None

    def drain_results(self) -> Dict[str, model_api.APIGenerateOutput]:
        """Pop every finished result."""
        with self._lock:
            out = dict(self._results)
            self._results.clear()
            for qid in out:
                self._result_events.pop(qid, None)
        return out

    # -- cancellation ------------------------------------------------------------

    def _finalize_cancel(self, qid: str):
        with self._lock:
            self._results.pop(qid, None)
            self._result_events.pop(qid, None)
            self._submit_ts.pop(qid, None)
        self._cancel_wanted.discard(qid)
        self.cancelled_total += 1
        self.tracer.event(qid, "engine.cancel", step=self._step_seq)

    def cancel(self, qid: str) -> bool:
        """Cancel a request wherever it lives (pending, preempted,
        decoding, parked, or finished but not collected), releasing every
        block it holds.  Call it from the thread that steps the engine.  A
        row caught mid-fill is cancelled once its fill completes (retried
        after each step's fills).  False for an unknown qid."""
        with self._lock:
            for i, req in enumerate(self._pending):
                if req.qid == qid:
                    self._pending.pop(i)
                    break
            else:
                req = None
        if req is not None:
            self._finalize_cancel(qid)
            return True
        for i, row in enumerate(self._preempted):
            if row.req.qid == qid:
                self._preempted.pop(i)
                self._finalize_cancel(qid)
                return True
        for row_id, row in enumerate(self.rows):
            if row is None or row.req.qid != qid:
                continue
            if row.filling:
                # the fill owns this row's blocks until it completes
                self._cancel_wanted.add(qid)
                return True
            if not row.parked:
                # the ring's snapshots name this row: fold them in first
                self._drain_ring()
                row = self.rows[row_id]
                if row is None or row.req.qid != qid:
                    # finished (or its slot reused) during the drain
                    self._finalize_cancel(qid)
                    return True
                if row.filling:
                    self._cancel_wanted.add(qid)
                    return True
            if not row.parked:
                self._set_rows("active", [row_id], [False])
            self._release_row(row_id)
            self._finalize_cancel(qid)
            return True
        with self._lock:
            known = qid in self._results or qid in self._result_events
        if known:
            self._finalize_cancel(qid)
            return True
        return False

    def _process_deferred_cancels(self):
        for qid in list(self._cancel_wanted):
            self._cancel_wanted.discard(qid)
            self.cancel(qid)  # defers itself again while still mid-fill

    # -- weight swaps ----------------------------------------------------------------

    def update_weights(
        self,
        params,
        version: Optional[int] = None,
        pre_sharded: bool = False,
    ) -> int:
        """Swap weights between chunks; in-flight rows' KV is recomputed
        under the new weights at the next step.  ``params`` may be the
        trainer's float32 master weights: they are copied in the serving
        types here.  ``pre_sharded`` marks a tree that already is this
        engine's serving copy on its device (a staged tree), which the
        swap takes as it is.  Returns the number of interrupted
        (in-flight) requests."""
        if not pre_sharded:
            # the copy is made now: the trainer goes on updating its
            # weights in place, and the swap applies the version of this
            # call
            params = self._serving_copy(params)
        with self._lock:
            self._new_params = (params, version, pre_sharded)
            return self.n_inflight

    def _serving_copy(self, params):
        """A copy of ``params`` in the engine's resident format on its
        device: quantized first when the engine serves int8 weights and
        the tree is full precision, then every leaf in its serving type
        (int8 ``qw`` and float32 ``scale`` stay as they are)."""
        if self._weight_quant and not quantize.is_quantized_tree(params):
            params = quantize.quantize_param_tree(params)
        return serving_params(params, self.cfg, self.device)

    def weight_restore_template(self, fmt: str):
        """The template an incoming published tree in ``fmt`` (``"full"``
        or ``"int8"``) restores onto: the resident tree when the formats
        agree; for an int8 engine offered a full-precision snapshot (the
        publisher wrote no int8 tree), the full tree's shapes and serving
        dtypes on the engine's device, restored and then quantized on
        arrival (:meth:`prepare_weights`)."""
        resident = "int8" if quantize.is_quantized_tree(self.params) else "full"
        if fmt == resident:
            return self.params
        if fmt == "full" and self._full_weight_template is not None:
            return self._full_weight_template
        if fmt == "int8":
            # an "auto" server never negotiates int8; a direct caller gets
            # the layout (meta tensors), as from the reference
            return quantize.quant_tree_struct(self.params)
        raise ValueError(f"unknown weight format {fmt!r}")

    def prepare_weights(self, params):
        """An incoming tree in the engine's resident format: an int8
        engine quantizes a full-precision tree on arrival; anything else
        passes through."""
        if self._weight_quant and not quantize.is_quantized_tree(params):
            return quantize.quantize_param_tree(params)
        return params

    def stage_context(self):
        """The CUDA stream staged copies run on (a side stream, so they
        overlap the decode chunks on the default stream); a no-op context
        on the CPU.  A caller that restores a snapshot for
        :meth:`stage_weights` on another thread restores inside it."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        if self._stage_stream is None:
            self._stage_stream = torch.cuda.Stream(self.device)
        return torch.cuda.stream(self._stage_stream)

    def stage_weights(self, params, version: int, owned: bool = False) -> int:
        """Make ``params``' serving copy on the engine's device while
        decode continues, and keep it as the STAGED tree for a later
        :meth:`commit_staged`: the copy is complete on the device when
        this returns, so the commit moves no bytes.  ``owned`` marks a
        tree that already is a serving copy on this device and belongs to
        nobody else (a snapshot restored onto
        :meth:`weight_restore_template`): it is kept as it is, not copied
        again.  Safe to call from a thread other than the engine's; only
        the staged slot is touched.  A stage whose version is not newer
        than the served one is dropped (the round already converged, e.g.
        by a full reload), not kept."""
        tik = time.perf_counter()
        with self.stage_context():
            if self.device.type == "cuda":
                # the source may still be written by work queued on the
                # caller's stream (a trainer's step)
                torch.cuda.current_stream(self.device).wait_stream(
                    torch.cuda.default_stream(self.device)
                )
            if not owned:
                params = self._serving_copy(params)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        with self._lock:
            self.swap_stage_s += time.perf_counter() - tik
            if version is not None and version <= self.version:
                logger.info(
                    "discarding stale staged weights v%s (engine already at "
                    "v%d)", version, self.version,
                )
                return version
            self._staged_params = params
            self._staged_version = version
        logger.info(
            "staged weights v%s in %.3fs (decode uninterrupted)",
            version, time.perf_counter() - tik,
        )
        return version

    @property
    def staged_version(self) -> Optional[int]:
        """Version of the staged (uncommitted) tree, if any."""
        return self._staged_version

    @property
    def pending_version(self) -> Optional[int]:
        """Target version of a committed swap not applied yet (the next
        unpaused step applies it), so a retried commit whose first reply
        was lost can be acknowledged."""
        with self._lock:
            return self._new_params[1] if self._new_params else None

    def commit_staged(self, expected_version: Optional[int] = None) -> int:
        """Commit the staged tree: the next step drains the ring and swaps
        by reference.  ``expected_version`` is the fleet's
        version-consistent barrier: a different staged version fails with
        nothing flipped.  Returns the interrupted-request count, like
        :meth:`update_weights`."""
        with self._lock:
            if self._staged_params is None:
                raise RuntimeError("no staged weights to commit")
            if (
                expected_version is not None
                and self._staged_version != expected_version
            ):
                raise RuntimeError(
                    f"staged weights are v{self._staged_version}, commit "
                    f"asked for v{expected_version}"
                )
            self._new_params = (self._staged_params, self._staged_version, True)
            self._staged_params = None
            self._staged_version = None
            return self.n_inflight

    def discard_staged(self):
        """Drop an uncommitted staged tree (an aborted round)."""
        with self._lock:
            self._staged_params = None
            self._staged_version = None

    def swap_stats(self) -> Dict[str, float]:
        """Cumulative weight-swap counters."""
        return {
            "stage_s": self.swap_stage_s,
            "pause_s": self.swap_pause_s,
            "swaps_total": self.swaps_total,
            "swaps_staged_total": self.swaps_staged_total,
        }

    def pause(self):
        """Quiesce: from the next step on, steps only drain the ring."""
        self._paused.set()

    def resume(self):
        self._paused.clear()

    def close(self) -> Dict[str, int]:
        """Leak audit by refcount: every pool block's refcount must equal
        the references held to it by the rows (decoding, filling and
        parked; a fill's blocks are its first target's row blocks) and the
        prefix cache, and the free stack must hold exactly the blocks
        nobody references, once each.  Returns ``{"kv_blocks": n}`` for
        the n blocks that disagree, ``{}`` when none does.  With no parked
        rows and a flushed cache, a whole pool is free.  Idempotent.  A
        dense engine holds no pool: ``{}``."""
        if not self.paged:
            return {}
        want = np.zeros(self.n_blocks, np.int64)
        for blocks in self._row_blocks:
            np.add.at(want, np.asarray(blocks, np.int64), 1)
        if self._prefix_cache is not None:
            np.add.at(
                want, np.asarray(self._prefix_cache.held_blocks(), np.int64), 1
            )
        free = np.zeros(self.n_blocks, np.int64)
        np.add.at(free, np.asarray(self._free_blocks, np.int64), 1)
        bad = (want != self._block_ref) | (free != (want == 0))
        n = int(bad.sum())
        return {"kv_blocks": n} if n else {}

    @property
    def n_inflight(self) -> int:
        """In-flight rows: decoding or chunk-filling (parked rows are idle
        KV residents)."""
        return sum(r is not None and not r.parked for r in self.rows)

    @property
    def n_decoding(self) -> int:
        """Rows with a pending token to decode (excludes filling and parked
        rows)."""
        return sum(
            r is not None and not r.parked and not r.filling for r in self.rows
        )

    @property
    def n_parked(self) -> int:
        return sum(r is not None and r.parked for r in self.rows)

    @property
    def n_pending(self) -> int:
        return len(self._pending)

    @property
    def inflight_chunks(self) -> int:
        """Decode chunks dispatched but not yet harvested."""
        return len(self._ring)

    def prefill_backlog_tokens(self) -> int:
        """Prompt tokens admitted to fills but not filled yet, plus the
        queued prompts."""
        backlog = sum(max(0, len(f.tokens) - f.fill_pos) for f in self._filling)
        with self._lock:
            for r in self._pending:
                backlog += len(r.input_ids or r.prompt_ids)
        return backlog

    @property
    def has_work(self) -> bool:
        # parked rows are idle and do not keep the loop going
        return (
            self.n_pending > 0
            or self.n_inflight > 0
            or bool(self._ring)
            or bool(self._filling or self._preempted)
        )

    # -- engine loop (owner thread) ------------------------------------------------

    def _apply_pending_weights(self):
        with self._lock:
            if self._new_params is None:
                return
            peek_version = self._new_params[1]
        # the apply window as a flight-recorder span beside the decode
        # chunks it interrupts (a swap is a fleet event: force-sampled)
        swap_root = (
            f"swap-v{peek_version}" if peek_version is not None
            else f"swap-v{self.version + 1}"
        )
        self.tracer.force(swap_root)
        self.tracer.span_begin(
            swap_root, "swap.commit", root=swap_root, version=peek_version
        )
        tik = time.perf_counter()
        # every dispatched chunk was computed under the old weights and is
        # folded in before the swap
        self._drain_ring()
        with self._lock:
            new_params, target_version, pre_sharded = self._new_params
            self._new_params = None
        if pre_sharded and self.device.type == "cuda":
            # a staged tree was made on the stage stream and is read on
            # this one from now on: its memory must not be handed back to
            # the stage stream before this stream's reads are done
            stream = torch.cuda.current_stream(self.device)
            for leaf in _leaves(new_params):
                leaf.record_stream(stream)
        self.params = new_params
        self.version = (
            target_version if target_version is not None else self.version + 1
        )
        with self._lock:
            # an uncommitted staged tree at or below the version just
            # applied is dead weight: free it now
            if (
                self._staged_version is not None
                and self._staged_version <= self.version
            ):
                logger.info(
                    "dropping stale staged weights v%d (applied v%d)",
                    self._staged_version, self.version,
                )
                self._staged_params = None
                self._staged_version = None
        # parked rows hold KV of the old weights: release them (their
        # continuations prefill under the new weights)
        for row_id, row in enumerate(self.rows):
            if row is not None and row.parked:
                self._release_row(row_id)
        # cached KV is of the old weights too: drop it, and reject inserts
        # tagged with the old version
        if self._prefix_cache is not None:
            self._prefix_cache.flush(new_version=self.version)
        # filling rows restart from scratch under the new weights (their
        # rows and blocks stay; a cache-matched fill_pos resets too: its
        # prefix blocks are rewritten like any others)
        for f in self._filling:
            f.fill_pos = 0
        # decoding rows recompute their cached KV (all but the pending
        # token, whose KV the next decode step writes) into their blocks
        entries = [
            (rid, (row.prompt + row.generated)[:-1])
            for rid, row in enumerate(self.rows)
            if row is not None and not row.filling
        ]
        for rid, _ in entries:
            self.tracer.event(
                self.rows[rid].req.qid, "engine.recompute", version=self.version
            )
        if entries and self.paged:
            self._refill_rows_paged(entries)
        elif entries:
            # the dense cache recomputes each row's whole sequence; the
            # first tokens it samples are dropped, the pending ones stay
            self._prefill_rows(entries)
            ids = [rid for rid, _ in entries]
            self._set_rows(
                "cur_tokens", ids, [self.rows[rid].cur_token for rid in ids]
            )
        dt = time.perf_counter() - tik
        self.swap_pause_s += dt
        self.swaps_total += 1
        self.swaps_staged_total += int(pre_sharded)
        if self._slo_enabled:
            # every in-flight request waited the window out; rows out of
            # service for a preemption count that whole span at their
            # re-activation instead
            for row in self.rows:
                if row is not None and not row.parked and not row.t_preempt:
                    row.slo_stall_s += dt
        self.tracer.span_end(
            swap_root, "swap.commit", root=swap_root, version=self.version,
            pre_sharded=pre_sharded, interrupted=self.n_inflight,
        )
        logger.info(
            "weights updated to v%d (%d in-flight recomputed, %s, %.3fs "
            "interrupted)", self.version, self.n_inflight,
            "pointer-flip" if pre_sharded else "full reload", dt,
        )

    def _try_resume(self, req: model_api.APIGenerateInput) -> bool:
        """Resume a parked row whose resident KV matches this continuation:
        the same qid AND a prompt equal to the row's tokens (a client that
        edited the context falls through to a fresh fill)."""
        prompt = list(req.input_ids or req.prompt_ids)
        for row_id, row in enumerate(self.rows):
            if (
                row is None
                or not row.parked
                or row.req.qid != req.qid
                or row.prompt + row.generated != prompt
            ):
                continue
            if len(prompt) + 1 >= self.kv_cache_len:
                # no room to continue: report empty so the client stops
                self._release_row(row_id)
                done = _Row(
                    req=req, prompt=prompt, generated=[], logprobs=[],
                    version_start=self.version, no_eos=True,
                )
                self._finish(-1, done, started=False)
                return True
            max_new = req.gconfig.max_new_tokens
            if len(prompt) + max_new > self.kv_cache_len:
                max_new = max(1, self.kv_cache_len - len(prompt))
            # the pool holds KV for prompt[:-1]; prompt[-1] is the pending
            # cur_token, so decoding picks up where the last chunk stopped
            row.req = req
            row.prompt = prompt
            row.generated = []
            row.logprobs = []
            row.version_start = self.version
            row.no_eos = False
            row.parked = False
            row.budget_left = max_new
            row.versions = []
            self._slo_admitted(row)
            self._epoch_counter += 1
            row.epoch = self._epoch_counter
            ids = [row_id]
            self._set_rows("cur_tokens", ids, [row.cur_token])
            self._set_rows("active", ids, [True])
            self._set_rows("budgets", ids, [max_new])
            self._set_rows("row_seeds", ids, [_qid_seed(req.qid)])
            self.resumed_total += 1
            self.tracer.event(req.qid, "engine.resume", row=row_id)
            return True
        return False

    def _evict_parked(self, keep_qids=()) -> Optional[int]:
        """Free the longest-parked row (its continuation will prefill);
        oldest by (park_step, row_id)."""
        oldest, oldest_id = None, None
        for row_id, row in enumerate(self.rows):
            if row is not None and row.parked and row.req.qid not in keep_qids:
                if oldest is None or row.park_step < oldest:
                    oldest, oldest_id = row.park_step, row_id
        if oldest_id is not None:
            self._release_row(oldest_id)
        return oldest_id

    def _store_mask(self, batch, written=None) -> Optional[np.ndarray]:
        """None when the chunk's rows write distinct pool slots that
        ``written`` (a bool per pool slot, or None) does not mark; else the
        ``[n, C]`` positions to store: each slot from its first writer in
        batch order only, and none already marked.  The slots stored are
        then marked.  Rows share a slot only inside shared full blocks (a
        sampling group, a cached prefix), where they write the KV of the
        same tokens at the same position, as every sharer does when a
        weight swap recomputes them; which of several writes of one slot
        in one scatter lands is unspecified on CUDA."""
        BS = self.page_size
        slots = []
        for f, take in batch:
            pos = np.arange(f.fill_pos, f.fill_pos + take)
            blk = np.asarray(f.blocks, np.int64)[pos // BS]
            slots.append(blk * BS + pos % BS)
        flat = np.concatenate(slots)
        _, first = np.unique(flat, return_index=True)
        keep = np.zeros(len(flat), bool)
        keep[first] = True
        if written is not None:
            keep &= ~written[flat]
            written[flat[keep]] = True
        if keep.all():
            return None
        C = max(take for _, take in batch)
        store = np.zeros((len(batch), C), bool)
        at = 0
        for i, (_, take) in enumerate(batch):
            store[i, :take] = keep[at : at + take]
            at += take
        return store

    def _run_fill_batch(self, fills: List[_Fill], budget: int, written=None):
        """Run ONE batched prefill chunk over ``fills`` (FIFO, total tokens
        <= budget), storing no slot twice (:meth:`_store_mask`).  Advances
        fill_pos; returns (completed fills, their logits rows, logits)."""
        batch: List[Tuple[_Fill, int]] = []
        left = budget
        for f in fills:
            rem = len(f.tokens) - f.fill_pos
            if rem <= 0:
                continue
            take = min(rem, left)
            if take <= 0:
                break
            batch.append((f, take))
            left -= take
            if left <= 0:
                break
        if not batch:
            return [], [], None
        C = max(take for _, take in batch)
        n = len(batch)
        toks = np.zeros((n, C), np.int32)
        starts = np.zeros((n,), np.int32)
        cls = np.zeros((n,), np.int32)
        tables = np.zeros((n, self.blocks_per_row), np.int32)
        for i, (f, take) in enumerate(batch):
            toks[i, :take] = f.tokens[f.fill_pos : f.fill_pos + take]
            starts[i] = f.fill_pos
            cls[i] = take
            tables[i, : len(f.blocks)] = f.blocks
        store = self._store_mask(batch, written)
        logits = paged.paged_fill_chunk(
            self.params,
            self.k_pool,
            self.v_pool,
            self.cfg,
            self._to_device(toks),
            self._to_device(starts),
            self._to_device(cls),
            self._to_device(tables),
            self.k_scale,
            self.v_scale,
            None if store is None else self._to_device(store),
        )
        self.prefill_calls += 1
        self.one_token_fill_calls += int(C == 1)
        self.prefill_tokens_total += int(cls.sum())
        completed, idxs = [], []
        for i, (f, take) in enumerate(batch):
            f.fill_pos += take
            if f.fill_pos == len(f.tokens):
                completed.append(f)
                idxs.append(i)
        return completed, idxs, logits

    def _refill_rows_paged(self, entries: List[Tuple[int, List[int]]]):
        """Recompute rows' cached KV into their EXISTING blocks (the weight
        swap's recompute; no sampling: the pending cur_tokens stay).  A
        slot of a block shared by several rows is stored once, by the first
        sharer in row order, whose chunks read nothing another sharer
        wrote: the shared blocks' bytes are those of one row's recompute,
        the same at every swap to the same weights while that row's first
        chunks are."""
        pending = [
            _Fill(key=(), tokens=seq, blocks=self._row_blocks[rid], targets=[])
            for rid, seq in entries
            if seq
        ]
        written = np.zeros(self.n_blocks * self.page_size, bool)
        while pending:
            self._run_fill_batch(pending, self.prefill_chunk_tokens, written)
            pending = [f for f in pending if f.fill_pos < len(f.tokens)]

    def _advance_fill(self):
        """Advance in-flight chunked prefills: one ``prefill_chunk_tokens``
        batch per step while rows are decoding (bounding their stall at
        one chunk), every chunk back to back while none is."""
        while self._filling:
            completed, idxs, logits = self._run_fill_batch(
                self._filling, self.prefill_chunk_tokens
            )
            if completed:
                for f in completed:
                    self._filling.remove(f)
                self._distribute_fills(completed, idxs, logits)
            elif logits is None:
                return  # nothing advanced: no fill has tokens left
            if self.n_decoding > 0:
                return

    def _distribute_fills(self, fills: List[_Fill], idxs, logits):
        """Hand completed fills' blocks to their targets: target 0 owns the
        canonical blocks; later targets share the FULL blocks (refcount)
        and get a COPY of the partial tail block (their generated tokens
        diverge inside it).  Fresh targets sample their first token from
        the fill's final logits; preempted targets restore their saved
        decode state and sample nothing.  The completed prompt enters the
        radix cache."""
        copy_src: List[int] = []
        copy_dst: List[int] = []
        sample_targets: List[Tuple[_Fill, _FillTarget, int]] = []
        activation: List[Tuple[int, int, int, int, _Row]] = []
        for f, li in zip(fills, idxs):
            plen = len(f.tokens)
            n_full = plen // self.page_size
            has_tail = plen % self.page_size != 0
            # a retried or sibling request arriving next step already hits
            self._cache_insert(f.tokens, f.blocks)
            for t_i, tgt in enumerate(f.targets):
                if t_i == 0:
                    self._set_row_blocks(tgt.row_id, list(f.blocks))
                else:
                    shared = f.blocks[:n_full]
                    self._incref_blocks(shared)
                    own = list(shared)
                    if has_tail:
                        tail = self._alloc_blocks(1)
                        while tail is None:
                            if (
                                self._prefix_cache is not None
                                and self._prefix_cache.evict_one()
                            ):
                                pass
                            elif self._evict_parked() is None:
                                victim = self._pick_preemption_victim(
                                    exclude=-1
                                )
                                if victim is not None:
                                    self._preempt_row(victim)
                                elif not self._abort_youngest_fill():
                                    raise RuntimeError(
                                        "KV pool exhausted distributing a "
                                        "group fill"
                                    )
                            tail = self._alloc_blocks(1)
                        copy_src.append(f.blocks[n_full])
                        copy_dst.append(tail[0])
                        own += tail
                    self._set_row_blocks(tgt.row_id, own)
                if tgt.resume is not None:
                    row = tgt.resume
                    if self._slo_enabled and row.t_preempt:
                        # back in service: the preempted span was stall
                        row.slo_stall_s += time.monotonic() - row.t_preempt
                        row.t_preempt = 0.0
                    self._epoch_counter += 1
                    row.epoch = self._epoch_counter
                    row.filling = False
                    self.rows[tgt.row_id] = row
                    activation.append(
                        (tgt.row_id, row.cur_token, row.budget_left, plen, row)
                    )
                else:
                    sample_targets.append((f, tgt, li))
        if copy_src:
            self._copy_pool_blocks(copy_src, copy_dst)
        if sample_targets:
            src = torch.as_tensor(
                [li for _, _, li in sample_targets], dtype=torch.long
            ).to(self.device)
            seeds = torch.as_tensor(
                [_qid_seed(t.req.qid) for _, t, _ in sample_targets],
                dtype=torch.int64,
            ).to(self.device)
            pos = torch.as_tensor(
                [len(f.tokens) for f, _, _ in sample_targets], dtype=torch.int64
            ).to(self.device)
            toks, logps = sample_logits_keyed(
                logits[src].float(), self.seed, seeds, pos, self.sampling
            )
            t_first = time.monotonic()  # the fill's first tokens on the host
            for (f, tgt, _), tok, logp in zip(
                sample_targets, toks.cpu().tolist(), logps.cpu().tolist()
            ):
                row = self.rows[tgt.row_id]
                row.generated = [int(tok)]
                row.logprobs = [float(logp)]
                row.versions = [self.version]
                row.filling = False
                self._slo_first_token(row, now=t_first)
                if tok in self.stop_tokens or tgt.max_new <= 1:
                    row.no_eos = tok not in self.stop_tokens
                    self._finish(tgt.row_id, row, started=False)
                    self._release_row(tgt.row_id)
                    continue
                row.cur_token = int(tok)
                row.budget_left = tgt.max_new - 1
                self._epoch_counter += 1
                row.epoch = self._epoch_counter
                activation.append(
                    (tgt.row_id, int(tok), tgt.max_new - 1, len(f.tokens), row)
                )
        # a resume target activated earlier in this loop may have been
        # preempted by a later target's tail allocation (its slot is free
        # again, its table zeroed): activate only rows still in their slot
        activation = [a for a in activation if self.rows[a[0]] is a[4]]
        if activation:
            ids = [a[0] for a in activation]
            self._set_rows("cur_tokens", ids, [a[1] for a in activation])
            self._set_rows("active", ids, [True] * len(ids))
            self._set_rows("budgets", ids, [a[2] for a in activation])
            self._set_rows("kv_lengths", ids, [a[3] for a in activation])
            self._set_rows(
                "row_seeds", ids, [_qid_seed(a[4].req.qid) for a in activation]
            )

    def _admit_paged(self):
        if self.hold_admissions:
            return
        for row_id, row in enumerate(self.rows):
            if row is not None and row.parked and (
                self._step_seq - row.park_step > self.park_ttl_steps
            ):
                self._release_row(row_id)
        free = [i for i, r in enumerate(self.rows) if r is None]

        def queued_qids():
            with self._lock:
                return {r.qid for r in self._pending}

        def take_row():
            if free:
                return free.pop(0)
            return self._evict_parked(keep_qids=queued_qids())

        # preempted rows first (their blocks were taken mid-decode; FIFO so
        # none starves).  Their re-prefill walks the radix cache like any
        # admission: only the prefix the cache lost is recomputed
        while self._preempted:
            row = self._preempted[0]
            seq = (row.prompt + row.generated)[:-1]
            rid = take_row()
            if rid is None:
                break
            fill = self._new_fill(seq, keep_qids=queued_qids())
            if fill is None:
                free.insert(0, rid)
                break
            self._preempted.pop(0)
            self._set_row_blocks(rid, fill.blocks)
            row.filling = True
            self.rows[rid] = row
            fill.targets.append(
                _FillTarget(
                    row_id=rid, req=row.req, max_new=row.budget_left,
                    resume=row,
                )
            )
            self._filling.append(fill)
        while True:
            with self._lock:
                if not self._pending:
                    break
                req = self._pending.pop(0)
            if self._try_resume(req):
                continue
            prompt = list(req.input_ids or req.prompt_ids)
            if len(prompt) + 1 >= self.kv_cache_len:
                row = _Row(
                    req=req, prompt=prompt, generated=[], logprobs=[],
                    version_start=self.version, no_eos=True,
                )
                self._finish(-1, row, started=False)
                continue
            max_new = req.gconfig.max_new_tokens
            if len(prompt) + max_new > self.kv_cache_len:
                max_new = max(1, self.kv_cache_len - len(prompt))
            key = tuple(prompt)
            fill = next((f for f in self._filling if f.key == key), None)
            rid = take_row()
            if rid is None:
                with self._lock:
                    self._pending.insert(0, req)
                break
            if fill is None:
                # radix walk first: a cached prefix is pinned and skipped.
                # Reclamation spares parked rows whose continuation is
                # queued behind this request
                fill = self._new_fill(prompt, keep_qids=queued_qids())
                if fill is None:
                    free.insert(0, rid)
                    with self._lock:
                        self._pending.insert(0, req)
                    break
                self._filling.append(fill)
                # the canonical blocks live in target 0's table
                self._set_row_blocks(rid, fill.blocks)
            # else: a group member joins the in-flight fill, with no
            # prefill of its own
            fill.targets.append(_FillTarget(row_id=rid, req=req, max_new=max_new))
            row = _Row(
                req=req, prompt=prompt, generated=[], logprobs=[],
                version_start=self.version, filling=True,
            )
            self._slo_admitted(row)
            self.rows[rid] = row

    def _ensure_decode_blocks(self):
        """Every decoding row's table must cover ``length + chunk`` slots
        before a decode dispatch (the chunk allocates nothing on the
        device), counting the tokens of chunks still in the ring.  Under
        pool pressure: reclaim cache entries, then parked rows, then
        preempt the youngest decoding rows.  With speculative decoding a
        verify window may write ``max_draft_tokens + 1`` slots in one
        dispatch, so coverage holds for either kind of dispatch."""
        W = self.chunk_size
        if self._spec is not None:
            W = max(W, self._spec.max_draft_tokens + 1)
        # every un-harvested chunk that snapshot a row may have advanced it
        # by W tokens the host has not folded in yet
        pend_counts: Dict[int, int] = {}
        for ch in self._ring:
            for rid, _ in ch.snapshot:
                pend_counts[rid] = pend_counts.get(rid, 0) + 1
        for row_id in range(self.max_batch):
            row = self.rows[row_id]
            if row is None or row.parked or row.filling:
                continue
            host_len = (len(row.prompt) + len(row.generated) + 1
                        + pend_counts.get(row_id, 0) * W)
            need = min(-(-(host_len + W) // self.page_size), self.blocks_per_row)
            while need > len(self._row_blocks[row_id]):
                blocks = self._alloc_blocks(need - len(self._row_blocks[row_id]))
                if blocks is not None:
                    self._set_row_blocks(row_id, self._row_blocks[row_id] + blocks)
                    break
                # reclamation tiers: cache entries (recompute insurance:
                # they always yield to a live row), parked rows, preemption
                if self._prefix_cache is not None and self._prefix_cache.evict_one():
                    continue
                if self._evict_parked() is not None:
                    continue
                victim = self._pick_preemption_victim(exclude=row_id)
                if victim is None:
                    # no other row decodes: the rest of the pool is held by
                    # fills, of which the youngest gives its blocks back
                    # (the reference engine raises here); with no fill
                    # either, this row is alone and fits by construction
                    if self._abort_youngest_fill():
                        continue
                    raise RuntimeError(
                        "KV pool exhausted with no evictable rows; pool="
                        f"{self.n_blocks} blocks is too small for "
                        f"kv_cache_len={self.kv_cache_len}"
                    )
                self._preempt_row(victim)
                # the preemption DRAINED the ring: its chunks are now in
                # every row's generated tokens, so the counts taken above
                # would charge them twice; recount this row and zero the
                # counts of the rows that follow
                pend_counts.clear()
                if self.rows[row_id] is not row or row.parked:
                    break  # this very row finished or parked in the drain
                host_len = len(row.prompt) + len(row.generated) + 1
                need = min(
                    -(-(host_len + W) // self.page_size), self.blocks_per_row
                )

    def _row_priority(self, row: _Row) -> str:
        """The request's priority class (``metadata["priority_class"]``);
        unlabelled traffic is bulk."""
        return str((row.req.metadata or {}).get("priority_class", "bulk"))

    def _pick_preemption_victim(self, exclude: int) -> Optional[int]:
        """The youngest (highest-epoch) bulk decoding row, else the youngest
        interactive one: the youngest has the least cached work to throw
        away."""
        best, best_key = None, (-1, -1)
        for row_id, row in enumerate(self.rows):
            if row is None or row.parked or row.filling or row_id == exclude:
                continue
            is_bulk = 0 if self._row_priority(row) == "interactive" else 1
            key = (is_bulk, row.epoch)
            if key > best_key:
                best, best_key = row_id, key
        return best

    def _preempt_row(self, row_id: int):
        """Stop decoding a row and release its blocks; it re-admits through
        the fill queue when space frees up.  The ring is drained first: the
        victim's chunks must reach the host before its blocks can be
        handed to anyone else."""
        self._drain_ring()
        row = self.rows[row_id]
        if row is None or row.parked or row.filling:
            return  # the drain finished or parked the victim
        self._set_rows("active", [row_id], [False])
        self._release_row(row_id)
        if self._slo_enabled:
            row.t_preempt = time.monotonic()  # stalled until re-activation
        self._preempted.append(row)
        self.preempted_total += 1
        cls = self._row_priority(row)
        self.preempted_by_class[cls] = self.preempted_by_class.get(cls, 0) + 1

    def _abort_youngest_fill(self) -> bool:
        """Give back the blocks of the most recently admitted fill: its
        fresh requests return to the head of the queue and its preempted
        rows to the head of the preempted list, to be admitted again when
        space frees up.  False when nothing is filling.  Only a decoding
        row that needs a block no other tier can free calls this (a fill's
        blocks are allocated whole at admission, so fills can hold the
        rest of the pool)."""
        if not self._filling:
            return False
        f = self._filling.pop()
        # the fill's blocks are its first target's row blocks
        self._release_row(f.targets[0].row_id)
        for tgt in f.targets[1:]:
            self.rows[tgt.row_id] = None
        self._preempted[:0] = [t.resume for t in f.targets if t.resume]
        with self._lock:
            self._pending[:0] = [t.req for t in f.targets if not t.resume]
        self.aborted_fills_total += 1
        return True

    def _stop_fn(self, tok: torch.Tensor) -> torch.Tensor:
        stop = torch.zeros_like(tok, dtype=torch.bool)
        for s in self.stop_tokens:
            stop |= tok == s
        return stop

    def _sample_fn(self, logits, positions, seeds):
        # called once per decode step a chunk enqueues
        self.decode_steps_total += 1
        return sample_logits_keyed(
            logits, self.seed, seeds, positions, self.sampling
        )

    def _use_deep_kernel(self) -> bool:
        """Dispatch-table decision: run this chunk's prefix attention
        through the deep paged kernel when the batch's longest live
        context (plus the un-harvested ring allowance) reaches
        ``deep_min_context``.  Decided on the host from host state.  On the
        CPU both kernels' plain version is the same function, so the
        decision changes nothing there."""
        longest = 0
        for row in self.rows:
            # filling and parked rows are not in the decode batch: a long
            # prompt mid-prefill must not route the decoding rows' chunk
            if row is not None and not row.parked and not row.filling:
                longest = max(longest, len(row.prompt) + len(row.generated) + 1)
        thr = self.dispatch_table.deep_min_context
        return longest + len(self._ring) * self.chunk_size >= thr

    def _dispatch_chunk_paged(self):
        snapshot = [
            (i, r.epoch) for i, r in enumerate(self.rows)
            if r is not None and not r.parked and not r.filling
        ]
        if self._tables_dirty:
            self._tables = self._to_device(self._tables_np)
            self._tables_dirty = False
        deep = self._use_deep_kernel()
        (self.kv_lengths, out_t, out_l, emitted, self.cur_tokens,
         self.active, self.budgets) = paged.paged_decode_chunk(
            self.params,
            self.k_pool,
            self.v_pool,
            self.cfg,
            self._tables,
            self.kv_lengths,
            self.cur_tokens,
            self.active,
            self.budgets,
            self.chunk_size,
            self._sample_fn,
            self._stop_fn,
            max_len=self.kv_cache_len,
            row_seeds=self.row_seeds,
            deep_kernel=deep,
            k_scale=self.k_scale,
            v_scale=self.v_scale,
        )
        self.decode_chunks_total += 1
        self.deep_decode_chunks_total += int(deep)
        self._enqueue_chunk((out_t, out_l, emitted, self.active), snapshot)

    # -- speculative decoding (paged path) ---------------------------------------

    def _spec_row_state(self, row: _Row) -> spec_decode.SpecRowState:
        if row.spec is None:
            row.spec = spec_decode.SpecRowState()
        return row.spec

    def _dispatch_spec_step(self) -> bool:
        """One speculative dispatch round, decided by a batch vote: either
        every live row rides ONE verify window (rows with drafts verify
        them; the others ride with an empty draft, whose first position is
        a plain decode step), or every live row takes a plain decode
        chunk, never a mix.  A verify pass costs
        ``verify_cost_over_decode_step`` plain steps, so it wins iff the
        rows' EMA-expected emission beats that per live row.  Rows that
        keep missing fall back or cool down, so a wave without repetition
        soon votes plain every step and keeps the pipeline's depth (the
        ring is drained only when a row wants to draft).  True when
        anything was dispatched."""
        spec = self._spec
        candidates = {
            rid for rid, r in enumerate(self.rows)
            if r is not None and not r.parked and not r.filling
            and self._spec_row_state(r).wants_draft(self._step_seq)
        }
        # drafting reads the exact host history: fold in every chunk that
        # covers a row about to draft
        while self._ring and any(
            rid in candidates for ch in self._ring for rid, _ in ch.snapshot
        ):
            self._harvest_oldest()
        live: List[int] = []
        drafts: Dict[int, List[int]] = {}
        attempted: List[int] = []
        expected = 0.0
        for rid, row in enumerate(self.rows):
            if row is None or row.parked or row.filling:
                continue
            live.append(rid)
            st = self._spec_row_state(row)
            if rid in candidates:
                attempted.append(rid)
                d = st.draft(row.prompt + row.generated, spec)
                if d:
                    drafts[rid] = d
                    expected += 1.0 + st.ema * len(d)
                    continue
            expected += 1.0
        if not live:
            return False
        spec_won = bool(drafts) and (
            expected >= spec.verify_cost_over_decode_step * len(live)
        )
        # an attempt was productive only if it hit AND the batch voted for
        # speculation: misses and lost votes both cool the row down
        for rid in attempted:
            self.rows[rid].spec.note_draft_result(
                spec_won and rid in drafts, self._step_seq
            )
        if spec_won:
            self._dispatch_verify_chunk(live, drafts)
        else:
            self._dispatch_chunk_paged()
        return True

    def _dispatch_verify_chunk(
        self, live_rows: List[int], drafts: Dict[int, List[int]]
    ):
        """Dispatch ONE batched verify window over every live row
        (:func:`~areal_tpu_torch.engine.spec_decode.paged_verify_chunk`):
        rows in ``drafts`` verify their proposals, the others ride with an
        empty draft.  The window width buckets to the step's longest
        draft; the outputs enter the ring as an ordinary chunk and the
        acceptance bookkeeping happens at harvest."""
        snapshot = [(i, self.rows[i].epoch) for i in live_rows]
        C = spec_window_bucket(1 + max(len(d) for d in drafts.values()))
        draft_arr = np.zeros((self.max_batch, C - 1), np.int32)
        draft_lens = np.zeros((self.max_batch,), np.int32)
        parts = np.zeros((self.max_batch,), bool)
        meta: Dict[int, Tuple[str, int]] = {}
        for rid in live_rows:
            parts[rid] = True
            d = drafts.get(rid)
            if not d:
                continue
            d = d[: C - 1]
            draft_arr[rid, : len(d)] = d
            draft_lens[rid] = len(d)
            meta[rid] = (self.rows[rid].req.qid, len(d))
        if self._tables_dirty:
            self._tables = self._to_device(self._tables_np)
            self._tables_dirty = False
        (self.kv_lengths, out_t, out_l, emitted, self.cur_tokens,
         self.active, self.budgets) = spec_decode.paged_verify_chunk(
            self.params,
            self.k_pool,
            self.v_pool,
            self.cfg,
            self._tables,
            self.kv_lengths,
            self.cur_tokens,
            self._to_device(draft_arr),
            self._to_device(draft_lens),
            self._to_device(parts),
            self.active,
            self.budgets,
            max_draft=C - 1,
            stop_fn=self._stop_fn,
            sampling=self.sampling,
            max_len=self.kv_cache_len,
            k_scale=self.k_scale,
            v_scale=self.v_scale,
        )
        self.spec_verify_chunks_total += 1
        self.spec_drafted_total += int(draft_lens.sum())
        self._enqueue_chunk(
            (out_t, out_l, emitted, self.active), snapshot, spec_meta=meta
        )

    def spec_stats(self) -> Dict[str, int]:
        """Cumulative speculative-decoding counters."""
        return {
            "drafted_total": self.spec_drafted_total,
            "accepted_total": self.spec_accepted_total,
            "rejected_total": self.spec_rejected_total,
            "verify_chunks_total": self.spec_verify_chunks_total,
            "draft_row_passes_total": self.spec_draft_row_passes_total,
            "fallback_rows_total": self.spec_fallback_rows_total,
        }

    def drain_spec_accept_samples(self) -> List[float]:
        """Pop the recent per-verify acceptance fractions (the server feeds
        them to its acceptance-rate histogram)."""
        out = list(self._spec_accept_samples)
        self._spec_accept_samples.clear()
        return out

    # -- the dense cache -----------------------------------------------------------

    def _prefill_rows(
        self,
        entries: List[Tuple[int, List[int]]],
        seeds: Optional[List[int]] = None,
    ):
        """Batched prefill of ``(row_id, tokens)`` entries into the dense
        cache; returns each entry's sampled next token and its logprob
        (host lists).  Entries with the same tokens (a sampling group's
        copies of one prompt) share one prefill.  ``seeds`` are the
        entries' request sampler keys; None takes them from the resident
        rows (the weight-swap recompute, whose samples are dropped)."""
        if seeds is None:
            seeds = [_qid_seed(self.rows[rid].req.qid) for rid, _ in entries]
        uniq: Dict[Tuple[int, ...], int] = {}
        src_idx = []
        for _, seq in entries:
            src_idx.append(uniq.setdefault(tuple(seq), len(uniq)))
        T = min(
            bucket_len(max(max(len(seq) for _, seq in entries), 1)),
            self.kv_cache_len,
        )
        toks = np.zeros((len(uniq), T), np.int32)
        lens = np.ones((len(uniq),), np.int32)
        for key, i in uniq.items():
            toks[i, : len(key)] = key
            lens[i] = len(key)
        tok, logp = _admit_rows(
            self.params, self.cfg, self.cache,
            self._to_device(toks),
            self._to_device(lens),
            self._to_device(np.asarray([rid for rid, _ in entries], np.int64)),
            self._to_device(np.asarray(src_idx, np.int64)),
            self._to_device(np.asarray(seeds, np.int64)),
            self.seed, self.sampling,
        )
        self.prefill_calls += 1
        self.prefill_tokens_total += int(lens.sum())
        return tok.cpu().tolist(), logp.cpu().tolist()

    def _admit(self):
        """The dense cache's admission: resume parked continuations, then
        prefill the queued prompts that fit into free rows (parked rows
        are evicted for room, except those whose continuation is queued)
        in one batch, and sample their first tokens."""
        if self.hold_admissions:
            return
        for row_id, row in enumerate(self.rows):
            if row is not None and row.parked and (
                self._step_seq - row.park_step > self.park_ttl_steps
            ):
                self._release_row(row_id)
        free = [i for i, r in enumerate(self.rows) if r is None]
        to_admit: List[Tuple[int, model_api.APIGenerateInput, List[int], int]] = []
        while True:
            with self._lock:
                if not self._pending:
                    break
                req = self._pending.pop(0)
            if self._try_resume(req):
                continue
            if not free:
                with self._lock:
                    queued = {r.qid for r in self._pending}
                evicted = self._evict_parked(keep_qids=queued)
                if evicted is None:
                    with self._lock:
                        self._pending.insert(0, req)
                    break
                free.append(evicted)
            prompt = list(req.input_ids or req.prompt_ids)
            if len(prompt) + 1 >= self.kv_cache_len:
                # no room: finish with no output so the client stops
                row = _Row(
                    req=req, prompt=prompt, generated=[], logprobs=[],
                    version_start=self.version, no_eos=True,
                )
                self._finish(-1, row, started=False)
                continue
            max_new = req.gconfig.max_new_tokens
            if len(prompt) + max_new > self.kv_cache_len:
                max_new = max(1, self.kv_cache_len - len(prompt))
            to_admit.append((free.pop(0), req, prompt, max_new))
        if not to_admit:
            return
        t_admit = time.monotonic()
        toks, logps = self._prefill_rows(
            [(rid, prompt) for rid, _, prompt, _ in to_admit],
            seeds=[_qid_seed(req.qid) for _, req, _, _ in to_admit],
        )
        t_first = time.monotonic()  # the first tokens on the host
        started = []
        for (row_id, req, prompt, max_new), tok, logp in zip(
            to_admit, toks, logps
        ):
            row = _Row(
                req=req, prompt=prompt, generated=[int(tok)],
                logprobs=[float(logp)], version_start=self.version,
                versions=[self.version],
            )
            self._slo_admitted(row, now=t_admit)
            self._slo_first_token(row, now=t_first)
            if tok in self.stop_tokens or max_new <= 1:
                row.no_eos = tok not in self.stop_tokens
                self._finish(row_id, row, started=False)
                continue
            row.cur_token = int(tok)
            row.budget_left = max_new - 1
            self._epoch_counter += 1
            row.epoch = self._epoch_counter
            self.rows[row_id] = row
            started.append((row_id, int(tok), max_new - 1, req.qid))
        if started:
            ids = [a[0] for a in started]
            self._set_rows("cur_tokens", ids, [a[1] for a in started])
            self._set_rows("active", ids, [True] * len(ids))
            self._set_rows("budgets", ids, [a[2] for a in started])
            self._set_rows("row_seeds", ids, [_qid_seed(a[3]) for a in started])

    def _attn_bucket(self, extra: int = 0) -> int:
        """The dense chunk's bound on every row's length: a power of two of
        the longest row (at least 256, at most ``kv_cache_len``), with
        ``extra`` for lengths the host has not harvested yet (one chunk
        per chunk in the ring)."""
        longest = 0
        for row in self.rows:
            if row is not None and not row.parked:
                longest = max(longest, len(row.prompt) + len(row.generated) + 1)
        need = min(longest + extra, self.kv_cache_len)
        p = 256
        while p < need:
            p <<= 1
        return min(p, self.kv_cache_len)

    def _dispatch_chunk(self):
        """Enqueue one dense decode chunk and its output copy."""
        snapshot = [
            (i, r.epoch) for i, r in enumerate(self.rows)
            if r is not None and not r.parked
        ]
        (self.cache, out_t, out_l, emitted, self.cur_tokens, self.active,
         self.budgets) = decode_chunk(
            self.params,
            self.cfg,
            self.cache,
            self.cur_tokens,
            self.active,
            self.budgets,
            self.chunk_size,
            self._sample_fn,
            self._stop_fn,
            attn_len=self._attn_bucket(
                extra=len(self._ring) * self.chunk_size
            ),
            row_seeds=self.row_seeds,
        )
        self.decode_chunks_total += 1
        self._enqueue_chunk((out_t, out_l, emitted, self.active), snapshot)

    def _enqueue_chunk(self, arrs, snapshot, spec_meta=None):
        """Append a dispatched chunk to the ring and start its output copy
        to pinned host memory, with an event recorded behind it."""
        if self.device.type == "cuda":
            host = tuple(
                torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(
                    x, non_blocking=True
                )
                for x in arrs
            )
            ready = torch.cuda.Event()
            ready.record()
        else:
            # copies: the engine updates its state tensors in place
            host, ready = tuple(x.clone() for x in arrs), None
        self._ring.append(_InflightChunk(
            host=host, ready=ready, snapshot=snapshot, spec_meta=spec_meta
        ))

    def _drain_ring(self) -> int:
        """Harvest every in-flight chunk, oldest first."""
        n = 0
        while self._ring:
            n += self._harvest_oldest()
        return n

    def _harvest_oldest(self) -> int:
        """Fold the OLDEST dispatched chunk's outputs into the host rows
        (FIFO: a row's tokens append in dispatch order).  Only rows of the
        dispatch-time snapshot with a matching epoch are touched."""
        if not self._ring:
            return 0
        chunk = self._ring.popleft()
        if chunk.ready is not None:
            chunk.ready.synchronize()
        out_t, out_l, emitted, active = (x.numpy() for x in chunk.host)
        n_tokens = 0
        t_harvest = time.monotonic()  # the chunk's tokens reach the host
        spec_meta = chunk.spec_meta
        for row_id, epoch in chunk.snapshot:
            row = self.rows[row_id]
            if row is None or row.parked or row.epoch != epoch:
                continue  # slot freed (and maybe reused) since the dispatch
            cols = emitted[row_id]
            toks = out_t[row_id][cols].tolist()
            if spec_meta is not None and row_id in spec_meta:
                _, drafted = spec_meta[row_id]
                # every emitted token but the last is a confirmed draft;
                # the last is the verifier's own (correction or bonus)
                n_acc = max(0, len(toks) - 1)
                self.spec_draft_row_passes_total += 1
                self.spec_accepted_total += n_acc
                self.spec_rejected_total += max(0, drafted - n_acc)
                self._spec_accept_samples.append(n_acc / max(drafted, 1))
                if row.spec is not None and row.spec.observe(
                    n_acc, drafted, self._spec
                ):
                    self.spec_fallback_rows_total += 1
            row.generated.extend(toks)
            row.logprobs.extend(out_l[row_id][cols].tolist())
            # the chunk ran under the served weights: a swap drains the
            # ring before it changes them
            row.versions.extend([self.version] * len(toks))
            row.budget_left -= len(toks)
            n_tokens += len(toks)
            if toks and self._slo_enabled:
                self._slo_first_token(row, now=t_harvest)
                row.t_last = t_harvest
            if not active[row_id]:
                last = row.generated[-1] if row.generated else -1
                row.no_eos = last not in self.stop_tokens
                # a budget-exhausted row with cache headroom stays resident
                # so its continuation resumes without a prefill
                park = (
                    row.no_eos
                    and len(row.prompt) + len(row.generated) + 1
                    < self.kv_cache_len
                )
                self._finish(row_id, row, park=park)
            elif toks:
                row.cur_token = toks[-1]
        self.decode_tokens_total += n_tokens
        return n_tokens

    def _finish(
        self, row_id: int, row: _Row, started: bool = True, park: bool = False
    ):
        """Publish ``row``'s result.  A ``started`` row (one that decoded in
        slot ``row_id``) enters the radix cache with its KV-bearing tokens
        and then parks (``park``) or releases its slot."""
        self._slo_finish(row)
        out = model_api.APIGenerateOutput.from_input(row.req)
        out.output_ids = list(row.generated)
        out.output_logprobs = list(row.logprobs)
        out.output_versions = list(row.versions)
        out.no_eos = row.no_eos
        out.version_start = row.version_start
        out.version_end = self.version
        self.gen_tokens_total += len(row.generated)
        if started and row_id >= 0:
            # the pool holds KV for prompt + generated[:-1] (the last token
            # is the pending one); inserting on park AND release lets the
            # next turn of a conversation, under any qid, prefill only its
            # new suffix
            if self.paged:
                self._cache_insert(
                    (row.prompt + row.generated)[:-1],
                    self._row_blocks[row_id],
                )
            if park:
                row.parked = True
                row.park_step = self._step_seq
                row.cur_token = row.generated[-1]
            else:
                self._release_row(row_id)
            self._set_rows("active", [row_id], [False])
        with self._lock:
            self._results[row.req.qid] = out
            ev = self._result_events.get(row.req.qid)
        if ev:
            ev.set()

    def _worth_dispatching(self) -> bool:
        """Skip a dispatch that could only decode rows the un-harvested ring
        is certain to finish (budget exhaustion is deterministic)."""
        if not self._ring:
            return True
        counts: Dict[Tuple[int, int], int] = {}
        for ch in self._ring:
            for key in ch.snapshot:
                counts[key] = counts.get(key, 0) + 1
        for row_id, row in enumerate(self.rows):
            if row is None or row.parked or row.filling:
                continue
            c = counts.get((row_id, row.epoch), 0)
            if row.budget_left > c * self.chunk_size:
                return True
        return False

    def step(self) -> int:
        """One engine iteration: weight swap (if requested), admit, advance
        fills, dispatch decode chunk N+K-1, then harvest chunk N, the
        oldest of up to ``pipeline_depth`` in-flight chunks.  A paused
        engine's step only drains the ring.  Returns the
        number of tokens harvested in this step, mid-step ring drains
        (weight swaps, preemptions) included."""
        self._step_seq += 1
        h0 = self.decode_tokens_total
        if self._paused.is_set():
            # paused means quiesced: fold in the whole ring, admit nothing
            n = self._drain_ring()
            if n == 0:
                time.sleep(0.01)
            return self.decode_tokens_total - h0
        self._apply_pending_weights()
        if self.paged:
            self._admit_paged()
            self._advance_fill()
            self._process_deferred_cancels()
            self._ensure_decode_blocks()
        else:
            self._admit()
        dispatched = False
        if (
            self.n_decoding > 0
            and len(self._ring) < self.pipeline_depth
            and self._worth_dispatching()
        ):
            if not self.paged:
                self._dispatch_chunk()
                dispatched = True
            elif self._spec is not None:
                dispatched = self._dispatch_spec_step()
            else:
                self._dispatch_chunk_paged()
                dispatched = True
        if len(self._ring) >= self.pipeline_depth or (
            not dispatched and self._ring
        ):
            self._harvest_oldest()
        return self.decode_tokens_total - h0


def _spec_tree(tree, cfg: TransformerConfig, device, name: str = ""):
    """``tree``'s layout as :class:`~areal_tpu_torch.engine.checkpoint.
    LeafSpec` leaves on ``device``: each leaf's shape in its serving dtype,
    with no data."""
    if isinstance(tree, dict):
        return {k: _spec_tree(v, cfg, device, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_spec_tree(v, cfg, device, name) for v in tree]
    return LeafSpec(tree.shape, serving_dtype(name, cfg), device)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree
