"""Continuous-batching inference engine over a paged KV pool, with
interruptible weight update (port of the paged path of
``areal_tpu/engine/inference_server.py``'s ``ContinuousBatchingEngine``).

Design, as in the reference:

* One shared block pool ``[L, NB, Hkv, BS, hd]`` and per-row block tables;
  capacity is allocated in ``page_size``-token pages as rows grow.
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
* ``update_weights(params)`` takes effect between chunks: the ring is
  drained, the weights swap, and every in-flight row's KV is recomputed
  under the new weights.
* Sampling is keyed on (engine seed, request seed, absolute position), so
  token streams do not depend on chunk size or pipeline depth.
* A :class:`~areal_tpu_torch.engine.dispatch.PagedDispatchTable` resolves
  ``cache_mode="auto"`` and routes a decode chunk to the deep paged
  kernel once the batch's longest live context reaches its
  ``deep_min_context``.
* ``kv_cache_dtype="int8"`` stores the pool as int8 with float32 scales
  per (block, head, slot); fill and decode chunks quantize at the scatter
  and both kernels dequantize at the read.

Left out of this slice, each rejected explicitly where a caller could ask
for it: the radix prefix cache and group-prompt block sharing, parking
and preemption (a finished row always releases its blocks, and the pool
is sized so that every row fits), speculative decode, int8 weights, P/D
handoff and fleet prefix pulls, SLO records and token streams,
tensor-parallel meshes, the dense cache mode, MoE models, and staged
weight swaps.
"""

from __future__ import annotations

import dataclasses
import threading
import zlib
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from areal_tpu_torch.api import model_api
from areal_tpu_torch.base.device import DeviceLike, resolve_device
from areal_tpu_torch.engine.dispatch import PagedDispatchTable
from areal_tpu_torch.engine.sampling import SamplingParams, sample_logits_keyed
from areal_tpu_torch.models import paged
from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.models.convert import serving_params

#: numpy types of the engine's device state tensors
_NP = {torch.int32: np.int32, torch.bool: np.bool_}


def _qid_seed(qid: str) -> int:
    """Per-request sampler-key identity: deterministic across processes and
    unique per request."""
    return zlib.crc32(qid.encode()) & 0x7FFFFFFF


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the torch engine yet (see ROADMAP.md)"
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
    budget_left: int = 0  # host-side view of remaining new-token budget
    # row reserved while its prompt prefills chunk by chunk
    filling: bool = False
    # bumped on every admission: a pipelined chunk's harvest touches only
    # the occupant its dispatch snapshotted
    epoch: int = 0


@dataclasses.dataclass
class _Fill:
    """An in-progress chunked prefill of one row's token sequence into its
    ``blocks``.  ``req`` is None for a weight-swap recompute, which
    samples nothing."""

    row_id: int
    req: Optional[model_api.APIGenerateInput]
    max_new: int
    tokens: List[int]
    blocks: List[int]
    fill_pos: int = 0


@dataclasses.dataclass
class _InflightChunk:
    """One dispatched-but-unharvested decode chunk: its outputs
    ``(out_t, out_l, emitted, active)`` as host tensors being filled by
    a non-blocking copy, the event recorded behind that copy (None on the
    CPU), and the dispatch-time ``(row_id, epoch)`` occupancy."""

    host: Tuple[torch.Tensor, ...]
    ready: Optional[torch.cuda.Event]
    snapshot: List[Tuple[int, int]]


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
        prefix_cache: bool = False,
        spec_decode_params=None,
        slo_tracking: bool = False,
        handoff_streaming: bool = False,
        mesh=None,
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

        ``kv_pool_tokens`` may only grow the pool beyond the dense
        equivalent ``max_batch * kv_cache_len``: a smaller pool needs
        preemption, which is not ported.

        ``dispatch_table`` (default: paged from 2048 tokens, deep kernel
        never) resolves ``cache_mode="auto"`` by ``kv_cache_len`` and picks
        the deep paged kernel for a decode chunk by the batch's longest
        live context.  ``kv_cache_dtype`` is ``"auto"`` (model-dtype pool)
        or ``"int8"`` (int8 pool with float32 scales)."""
        if cache_mode not in ("auto", "dense", "paged"):
            raise ValueError(f"unknown cache_mode {cache_mode!r}")
        self.dispatch_table = dispatch_table or PagedDispatchTable()
        paged_mode = cache_mode == "paged" or (
            cache_mode == "auto"
            and kv_cache_len >= self.dispatch_table.paged_min_cache_len
            and cfg.sliding_window is None
        )
        if not paged_mode:
            raise _not_ported(
                f"the dense cache mode (cache_mode={cache_mode!r}, "
                f"kv_cache_len={kv_cache_len}, paged from "
                f"{self.dispatch_table.paged_min_cache_len}; pass "
                "cache_mode='paged')"
            )
        if cfg.sliding_window is not None:
            raise ValueError(
                "the paged cache serves global-attention models; "
                "sliding-window models need the dense path"
            )
        if kv_cache_dtype not in ("auto", "int8"):
            raise ValueError(
                f"kv_cache_dtype must be 'auto' or 'int8', got {kv_cache_dtype!r}"
            )
        if serving_weight_dtype != "auto":
            raise _not_ported(
                f"serving_weight_dtype={serving_weight_dtype!r} (int8 weights)"
            )
        if prefix_cache:
            raise _not_ported("the radix prefix cache (prefix_cache=True)")
        if spec_decode_params is not None:
            raise _not_ported("speculative decoding (spec_decode_params)")
        if slo_tracking:
            raise _not_ported("SLO latency records (slo_tracking=True)")
        if handoff_streaming:
            raise _not_ported("streamed P/D KV handoff (handoff_streaming=True)")
        if mesh is not None:
            raise _not_ported("tensor-parallel serving (mesh)")
        if pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = serving_params(params, cfg, self.device)
        self.max_batch = max_batch
        self.kv_cache_len = kv_cache_len
        self.chunk_size = chunk_size
        self.pipeline_depth = pipeline_depth
        self.sampling = sampling or SamplingParams()
        self.stop_tokens = tuple(sorted(set(stop_tokens)))
        self.seed = seed
        self.version = 0
        self.kv_cache_dtype = kv_cache_dtype
        self._kv_quant = kv_cache_dtype == "int8"
        # quality counters of the int8 pool: parity harnesses fold their
        # greedy divergence checks in here
        self.kv_quant_divergence_checks_total = 0
        self.kv_quant_divergence_diverged_total = 0

        self._init_paged_state(page_size, kv_pool_tokens, prefill_chunk_tokens)

        self.rows: List[Optional[_Row]] = [None] * max_batch
        self._pending: List[model_api.APIGenerateInput] = []
        self._results: Dict[str, model_api.APIGenerateOutput] = {}
        self._result_events: Dict[str, threading.Event] = {}
        self._lock = threading.Lock()
        # pending swap: (params, target_version | None)
        self._new_params: Optional[Tuple[Any, Optional[int]]] = None
        self._epoch_counter = 0
        self._ring: Deque[_InflightChunk] = deque()
        # work counters: fill chunks and decode chunks dispatched (each
        # runs the paged kernel once per layer, decode chunks once per
        # layer and step; deep chunks through the deep kernel), tokens
        # prefilled and generated
        self.prefill_calls = 0
        self.prefill_tokens_total = 0
        self.decode_chunks_total = 0
        self.deep_decode_chunks_total = 0
        self.decode_tokens_total = 0  # tokens folded in from decode chunks

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
        dense_blocks = max_batch * self.blocks_per_row
        if kv_pool_tokens is not None and -(-kv_pool_tokens // BS) < dense_blocks:
            raise _not_ported(
                f"a pool smaller than max_batch * kv_cache_len (kv_pool_tokens="
                f"{kv_pool_tokens}) needs preemption, which"
            )
        self.n_blocks = max(dense_blocks, -(-(kv_pool_tokens or 0) // BS))
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
        # host allocator: LIFO free stack + refcounts
        self._free_blocks = list(range(self.n_blocks - 1, -1, -1))
        self._block_ref = np.zeros((self.n_blocks,), np.int32)
        self._row_blocks: List[List[int]] = [[] for _ in range(max_batch)]
        self._filling: List[_Fill] = []

    # -- host <-> device ------------------------------------------------------

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without synchronising the stream
        (a pageable copy would): pinned staging + non-blocking copy."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    def _set_rows(self, name: str, ids: np.ndarray, vals: np.ndarray):
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

    def _free_block_list(self, blocks: List[int]):
        for b in blocks:
            self._block_ref[b] -= 1
            if self._block_ref[b] < 0:
                raise RuntimeError(f"double free of pool block {b}")
            if self._block_ref[b] == 0:
                self._free_blocks.append(b)

    def _set_row_blocks(self, row_id: int, blocks: List[int]):
        self._row_blocks[row_id] = blocks
        t = self._tables_np[row_id]
        t[:] = 0
        t[: len(blocks)] = blocks
        self._tables_dirty = True

    def _release_row(self, row_id: int):
        """Single exit point for a row slot: frees its pool blocks."""
        self.rows[row_id] = None
        if self._row_blocks[row_id]:
            self._free_block_list(self._row_blocks[row_id])
            self._set_row_blocks(row_id, [])

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
        return {
            "quantized": int(self._kv_quant),
            "storage_bits": self.k_pool.element_size() * 8,
            "quantized_blocks_held": int(held),
            "divergence_checks_total": self.kv_quant_divergence_checks_total,
            "divergence_diverged_total": (
                self.kv_quant_divergence_diverged_total
            ),
        }

    def _new_fill(self, row_id: int, req, max_new: int, seq: List[int]):
        """A fill of ``seq`` into freshly allocated blocks (None when the
        pool cannot provide them)."""
        blocks = self._alloc_blocks(max(1, -(-len(seq) // self.page_size)))
        if blocks is None:
            return None
        return _Fill(row_id=row_id, req=req, max_new=max_new,
                     tokens=list(seq), blocks=blocks)

    # -- public API --------------------------------------------------------------

    def submit(self, req: model_api.APIGenerateInput) -> str:
        if (req.metadata or {}).get("stream"):
            raise _not_ported("token streaming (metadata['stream'])")
        if (req.metadata or {}).get("handoff_to"):
            raise _not_ported("P/D KV handoff (metadata['handoff_to'])")
        with self._lock:
            self._pending.append(req)
            self._result_events[req.qid] = threading.Event()
        return req.qid

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

    def update_weights(self, params, version: Optional[int] = None) -> int:
        """Swap weights between chunks; in-flight rows' KV is recomputed
        under the new weights at the next step.  ``params`` may be the
        trainer's float32 master weights: they are copied in the serving
        types here.  Returns the number of interrupted (in-flight)
        requests."""
        # the copy is made now: the trainer goes on updating its weights in
        # place, and the swap applies the version of this call
        new_params = serving_params(params, self.cfg, self.device)
        with self._lock:
            self._new_params = (new_params, version)
            return self.n_inflight

    def stage_weights(self, params, version: int) -> int:
        raise _not_ported("staged weight swaps (stage_weights)")

    def commit_staged(self, expected_version: Optional[int] = None) -> int:
        raise _not_ported("staged weight swaps (commit_staged)")

    def close(self) -> Dict[str, int]:
        """Leak audit: pool blocks held by no live row or fill
        (``{"kv_blocks": n}``; ``{}`` when the pool is whole).  Idempotent."""
        # a fill's blocks are its row's block list (the same object)
        owned = sum(len(b) for b in self._row_blocks)
        leaked = self.n_blocks - len(self._free_blocks) - owned
        return {"kv_blocks": leaked} if leaked else {}

    @property
    def n_inflight(self) -> int:
        """In-flight rows: decoding or chunk-filling."""
        return sum(r is not None for r in self.rows)

    @property
    def n_decoding(self) -> int:
        """Rows with a pending token to decode (excludes filling rows)."""
        return sum(r is not None and not r.filling for r in self.rows)

    @property
    def n_pending(self) -> int:
        return len(self._pending)

    @property
    def has_work(self) -> bool:
        return (
            self.n_pending > 0
            or self.n_inflight > 0
            or bool(self._ring)
            or bool(self._filling)
        )

    # -- engine loop (owner thread) ------------------------------------------------

    def _apply_pending_weights(self):
        with self._lock:
            if self._new_params is None:
                return
        # every dispatched chunk was computed under the old weights and is
        # folded in before the swap
        self._drain_ring()
        with self._lock:
            new_params, target_version = self._new_params
            self._new_params = None
        self.params = new_params
        self.version = (
            target_version if target_version is not None else self.version + 1
        )
        # filling rows restart from scratch under the new weights (their
        # rows and blocks stay)
        for f in self._filling:
            f.fill_pos = 0
        # decoding rows recompute their cached KV (all but the pending
        # token, whose KV the next decode step writes) into their blocks
        entries = [
            (rid, (row.prompt + row.generated)[:-1])
            for rid, row in enumerate(self.rows)
            if row is not None and not row.filling
        ]
        fills = [
            _Fill(row_id=rid, req=None, max_new=0, tokens=seq,
                  blocks=self._row_blocks[rid])
            for rid, seq in entries
            if seq
        ]
        while fills:
            self._run_fill_batch(fills, self.prefill_chunk_tokens)
            fills = [f for f in fills if f.fill_pos < len(f.tokens)]

    def _run_fill_batch(self, fills: List[_Fill], budget: int):
        """Run ONE batched prefill chunk over ``fills`` (FIFO, total tokens
        <= budget).  Advances fill_pos; returns (completed fills, their
        logits rows, logits)."""
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
        )
        self.prefill_calls += 1
        self.prefill_tokens_total += int(cls.sum())
        completed, idxs = [], []
        for i, (f, take) in enumerate(batch):
            f.fill_pos += take
            if f.fill_pos == len(f.tokens):
                completed.append(f)
                idxs.append(i)
        return completed, idxs, logits

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
        """Hand completed fills' blocks to their rows and sample each row's
        first token from the fill's final logits."""
        src = torch.as_tensor(idxs, dtype=torch.long, device=self.device)
        seeds = torch.as_tensor(
            [_qid_seed(f.req.qid) for f in fills], dtype=torch.int64
        ).to(self.device)
        pos = torch.as_tensor(
            [len(f.tokens) for f in fills], dtype=torch.int64
        ).to(self.device)
        toks, logps = sample_logits_keyed(
            logits[src].float(), self.seed, seeds, pos, self.sampling
        )
        toks = toks.cpu().tolist()
        logps = logps.cpu().tolist()
        activation: List[Tuple[int, int, int, int, int]] = []
        for f, tok, logp in zip(fills, toks, logps):
            row = self.rows[f.row_id]
            row.generated = [int(tok)]
            row.logprobs = [float(logp)]
            row.filling = False
            if tok in self.stop_tokens or f.max_new <= 1:
                row.no_eos = tok not in self.stop_tokens
                self._finish(f.row_id, row)
                continue
            row.budget_left = f.max_new - 1
            self._epoch_counter += 1
            row.epoch = self._epoch_counter
            activation.append(
                (f.row_id, int(tok), f.max_new - 1, len(f.tokens),
                 _qid_seed(f.req.qid))
            )
        if activation:
            a = np.array(activation, np.int64)
            ids = a[:, 0]
            self._set_rows("cur_tokens", ids, a[:, 1])
            self._set_rows("active", ids, np.ones(len(ids), bool))
            self._set_rows("budgets", ids, a[:, 2])
            self._set_rows("kv_lengths", ids, a[:, 3])
            self._set_rows("row_seeds", ids, a[:, 4])

    def _admit_paged(self):
        free = [i for i, r in enumerate(self.rows) if r is None]
        while free:
            with self._lock:
                if not self._pending:
                    break
                req = self._pending.pop(0)
            prompt = list(req.input_ids or req.prompt_ids)
            if len(prompt) + 1 >= self.kv_cache_len:
                row = _Row(
                    req=req, prompt=prompt, generated=[], logprobs=[],
                    version_start=self.version, no_eos=True,
                )
                self._finish(-1, row)
                continue
            max_new = req.gconfig.max_new_tokens
            if len(prompt) + max_new > self.kv_cache_len:
                max_new = max(1, self.kv_cache_len - len(prompt))
            rid = free.pop(0)
            fill = self._new_fill(rid, req, max_new, prompt)
            if fill is None:
                raise RuntimeError(
                    f"KV pool exhausted admitting {req.qid}: the pool is "
                    "sized for every row at full length, so this is a leak"
                )
            self._filling.append(fill)
            self._set_row_blocks(rid, fill.blocks)
            self.rows[rid] = _Row(
                req=req, prompt=prompt, generated=[], logprobs=[],
                version_start=self.version, filling=True,
            )

    def _ensure_decode_blocks(self):
        """Every decoding row's table must cover ``length + chunk`` slots
        before a decode dispatch (the chunk allocates nothing on the
        device), counting the tokens of chunks still in the ring."""
        W = self.chunk_size
        pend_counts: Dict[int, int] = {}
        for ch in self._ring:
            for rid, _ in ch.snapshot:
                pend_counts[rid] = pend_counts.get(rid, 0) + 1
        for row_id, row in enumerate(self.rows):
            if row is None or row.filling:
                continue
            n_pend = pend_counts.get(row_id, 0)
            host_len = len(row.prompt) + len(row.generated) + 1 + n_pend * W
            need = min(-(-(host_len + W) // self.page_size), self.blocks_per_row)
            deficit = need - len(self._row_blocks[row_id])
            if deficit > 0:
                blocks = self._alloc_blocks(deficit)
                if blocks is None:
                    raise RuntimeError(
                        "KV pool exhausted growing a decoding row: the pool "
                        "is sized for every row at full length, so this is "
                        "a leak"
                    )
                self._set_row_blocks(row_id, self._row_blocks[row_id] + blocks)

    def _stop_fn(self, tok: torch.Tensor) -> torch.Tensor:
        stop = torch.zeros_like(tok, dtype=torch.bool)
        for s in self.stop_tokens:
            stop |= tok == s
        return stop

    def _sample_fn(self, logits, positions, seeds):
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
            # filling rows are not in the decode batch: a long prompt
            # mid-prefill must not route the decoding rows' chunk
            if row is not None and not row.filling:
                longest = max(longest, len(row.prompt) + len(row.generated) + 1)
        thr = self.dispatch_table.deep_min_context
        return longest + len(self._ring) * self.chunk_size >= thr

    def _dispatch_chunk_paged(self):
        snapshot = [
            (i, r.epoch) for i, r in enumerate(self.rows)
            if r is not None and not r.filling
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

    def _enqueue_chunk(self, arrs, snapshot):
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
        self._ring.append(_InflightChunk(host=host, ready=ready, snapshot=snapshot))

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
        for row_id, epoch in chunk.snapshot:
            row = self.rows[row_id]
            if row is None or row.epoch != epoch:
                continue  # slot freed (and maybe reused) since the dispatch
            cols = emitted[row_id]
            toks = out_t[row_id][cols].tolist()
            row.generated.extend(toks)
            row.logprobs.extend(out_l[row_id][cols].tolist())
            row.budget_left -= len(toks)
            n_tokens += len(toks)
            if not active[row_id]:
                last = row.generated[-1] if row.generated else -1
                row.no_eos = last not in self.stop_tokens
                self._finish(row_id, row)
        self.decode_tokens_total += n_tokens
        return n_tokens

    def _finish(self, row_id: int, row: _Row):
        out = model_api.APIGenerateOutput.from_input(row.req)
        out.output_ids = list(row.generated)
        out.output_logprobs = list(row.logprobs)
        out.no_eos = row.no_eos
        out.version_start = row.version_start
        out.version_end = self.version
        if row_id >= 0:
            self._release_row(row_id)
            self._set_rows("active", np.array([row_id]), np.zeros(1, bool))
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
            if row is None or row.filling:
                continue
            c = counts.get((row_id, row.epoch), 0)
            if row.budget_left > c * self.chunk_size:
                return True
        return False

    def step(self) -> int:
        """One engine iteration: weight swap (if requested), admit, advance
        fills, dispatch decode chunk N+K-1, then harvest chunk N, the
        oldest of up to ``pipeline_depth`` in-flight chunks.  Returns the
        number of tokens harvested in this step."""
        h0 = self.decode_tokens_total
        self._apply_pending_weights()
        self._admit_paged()
        self._advance_fill()
        self._ensure_decode_blocks()
        dispatched = False
        if (
            self.n_decoding > 0
            and len(self._ring) < self.pipeline_depth
            and self._worth_dispatching()
        ):
            self._dispatch_chunk_paged()
            dispatched = True
        if len(self._ring) >= self.pipeline_depth or (
            not dispatched and self._ring
        ):
            self._harvest_oldest()
        return self.decode_tokens_total - h0

