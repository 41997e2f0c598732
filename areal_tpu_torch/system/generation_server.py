"""Generation server worker: hosts the continuous-batching engine (port of
``areal_tpu/system/generation_server.py`` as a unified, single-process,
one-device server).

The API is a ZMQ ROUTER socket:

* ``("generate", APIGenerateInput)`` -> ``APIGenerateOutput`` once done;
* ``("update_weights", {"path", "version", "format", "mode"})`` with
  ``mode`` ``"full"`` (restore and swap, on the poll thread), ``"stage"``
  (restore into a staged tree on a background thread while decode goes
  on; the reply comes when the tree is on the device) or ``"commit"``
  (swap the staged tree in at the next step; a retried commit of the
  version already applied or queued is acknowledged) ->
  ``{"num_interrupted", "version"}`` / ``{"staged", "stage_seconds"}``;
* ``("pause" | "resume", {})``, ``("stream_cancel", {"qid"})``;
* token streams: ``("generate_stream", APIGenerateInput)`` -> ``{"ok",
  "qid"}`` at once, then ``("stream_poll", {"qid"})`` -> ``{"tokens",
  "done", "result"}``: the tokens folded in since the last poll, and the
  result once the request finished (which closes the stream).  A stream
  nobody polled for the engine's ``stream_stale_steps`` steps is
  cancelled;
* ``("metrics", {})`` -> the engine's counters, swap times, SLO digests,
  stream counters, the HBM ledger's bytes and peaks and the compile
  watch's counters;
* prefill/decode disaggregation and the KV fabric, between servers:
  ``("import_handoff", {"unit"})``, ``("import_handoff_segment",
  {"segment"})`` -> ``{"imported", "reason"}``, and ``("export_prefix",
  {"qid", "tokens"})`` -> ``{"segments"}`` (empty, with a ``reason``, when
  nothing is cached).

A server registers under a role (``unified``, ``prefill`` or ``decode``)
that the gserver manager routes by.  A request whose metadata names
``handoff_to`` parks after its fill and first token; the server pushes its
KV to that decode server, streamed as numbered segments while later fill
chunks run (``handoff_streaming``, the default) or as one unit, and holds
the client's reply until the last segment is pushed, so the continuation
finds the row parked there.  A request whose metadata names ``kv_source``
pulls its cached prefix from that peer (``export_prefix``) before it
prefills the rest.  Segments travel over the ``host-numpy`` transport: a
segment's payload is host torch tensors (the pool's dtype, an int8 pool's
scales beside its bytes), which pickle carries over the peer's ZMQ
socket; the name is the fleet's vocabulary, kept for the manager's
routing.  ``tpu-d2d`` is a recognised transport with no backend.

``format="params"`` names a snapshot that
:func:`areal_tpu_torch.engine.checkpoint.save_params` wrote; any other
format names an HF checkpoint directory of the served architecture
(``models/hf``).  A server with ``serving_weight_dtype="int8"`` restores
the int8 sibling tree a publisher advertises in the snapshot's manifest
(``serving_quant``), and otherwise the full tree, quantized on arrival
(:meth:`GenerationServerWorker._negotiate_weight_format`).  The config's
``spec_decode`` block, ``prefix_cache_host_bytes`` and ``cache_mode``
("dense" and "auto", which serves a sliding-window model such as Mistral
on the dense cache) pass to the engine.

Each poll publishes the engine's counters and its HBM ledger into the
process registry, which the worker's ``/metrics`` server serves, and
polls the compile watch (:mod:`~areal_tpu_torch.observability.
compile_watch`) over the engine's kernel entries: with
``compile_quiet_after_steps`` > 0, a kernel library loaded for a watched
entry after that many engine steps fires the recompile sentinel.  Not
ported yet, each refused where a caller could ask for it: multi-process
servers and meshes of more than one device (ROADMAP.md queue 1, item 10).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import threading
import time
from collections import deque
from typing import Dict, Optional, Tuple

import zmq

from areal_tpu_torch.api import dataset_api, system_api
from areal_tpu_torch.base import (
    constants,
    logging_,
    monitor,
    name_resolve,
    names,
    network,
)
from areal_tpu_torch.engine.inference_server import _not_ported, wire_segment
from areal_tpu_torch.system import worker_base

#: serving roles a generation server may register under: ``prefill``
#: servers fill prompts and hand the rows' KV to a ``decode`` peer;
#: ``unified`` (the default) does both
SERVER_ROLES = ("prefill", "decode", "unified")

#: segment transports a generation server may register (``tpu-d2d`` is
#: recognised and has no backend)
SEGMENT_TRANSPORTS = ("host-numpy", "tpu-d2d")

#: config fields an HF directory swapped into a server may differ in from
#: the served model's (how it runs, not what it computes on which shapes)
_RUN_OPTIONS = ("dtype", "logits_dtype", "remat", "remat_policy")

#: the mesh-spec field of a one-device registration (the JAX package's
#: default ``MeshSpec``, so registrations read the same in both packages)
ONE_DEVICE_SPEC = "d1f1m1p1s1e1"

#: how long a poll whose engine step dispatched no device work waits for
#: a request (or a push, pull or stage of its own to settle) before the
#: next step.  The engine's clock counts steps: a server that stepped an
#: idle engine every 2 ms would expire a decode peer's half-received
#: stream (``handoff_pending_ttl_steps`` = 512) after about a second,
#: shorter than a busy prefill server may take between two segments
IDLE_WAIT_S = 0.05


def format_server_registration(
    addr: str, mesh_spec, role: str = "unified",
    transport: str = "host-numpy",
) -> str:
    """Registration value for the gen_servers name-resolve subtree:
    ``addr|mesh_devices|mesh_spec[|role][|transport]``.  ``mesh_spec`` is
    ``None`` for one device, else any object with ``world_size``; the role
    and transport are capability tokens appended only when they differ
    from the defaults, so registrations stay byte-stable."""
    world = int(getattr(mesh_spec, "world_size", 1))
    spec = ONE_DEVICE_SPEC if mesh_spec is None else str(mesh_spec)
    base = f"{addr}|{world}|{spec}"
    if role and role != "unified":
        if role not in SERVER_ROLES:
            raise ValueError(f"unknown server role {role!r}")
        base += f"|{role}"
    if transport and transport != "host-numpy":
        if transport not in SEGMENT_TRANSPORTS:
            raise ValueError(f"unknown segment transport {transport!r}")
        base += f"|{transport}"
    return base


def parse_server_registration(
    value: str,
) -> Tuple[str, int, str, str, str]:
    """``(addr, mesh_devices, mesh_spec_str, role, transport)`` from a
    registration value; bare addresses parse as one device, and missing or
    unknown capability tokens as ``unified`` / ``host-numpy``."""
    parts = value.split("|")
    addr = parts[0]
    devices = int(parts[1]) if len(parts) > 1 and parts[1] else 1
    spec = parts[2] if len(parts) > 2 else ""
    role, transport = "unified", "host-numpy"
    for token in parts[3:]:
        if token in SERVER_ROLES:
            role = token
        elif token in SEGMENT_TRANSPORTS:
            transport = token
    return addr, max(1, devices), spec, role, transport


class SegmentTransport:
    """The wire mechanics of ONE streamed KV segment.  The protocol
    (numbering, version checks, TTLs, aborts, fail-closed rejects) lives in
    the engine and the server; a transport only moves a segment to a peer.
    ``submit`` runs off the poll thread and returns a future of ``bool``
    (False: the peer rejected it or the push failed; the stream's remainder
    is dropped and the decode server prefills)."""

    name = "abstract"

    def __init__(self, worker: "GenerationServerWorker"):
        self._worker = worker

    def submit(self, qid: str, dest: str, seg: Dict):
        """Push ``seg`` to ``dest``; returns a Future[bool]."""
        raise NotImplementedError


class HostNumpyTransport(SegmentTransport):
    """The default transport: the push thread waits for the segment's
    device-to-host copies (:func:`~areal_tpu_torch.engine.inference_server.
    wire_segment`), so the poll thread never blocks on them, and sends the
    host tensors over the peer's ``import_handoff_segment`` RPC."""

    name = "host-numpy"

    def submit(self, qid: str, dest: str, seg: Dict):
        worker = self._worker
        client = worker._peer_client(dest)
        log = worker.logger
        timeout = worker.config.handoff_request_timeout

        def push() -> bool:
            try:
                resp = client.call("import_handoff_segment",
                                   {"segment": wire_segment(seg)},
                                   timeout=timeout)
                if isinstance(resp, dict) and resp.get("imported"):
                    return True
                log.warning(
                    "handoff segment %s/%s rejected by %s (%s); the decode "
                    "server prefills", qid, seg.get("seq"), dest,
                    resp.get("reason") if isinstance(resp, dict) else resp,
                )
            except Exception as e:  # noqa: BLE001 - fail closed
                log.warning(
                    "handoff segment %s/%s to %s failed (%r); the decode "
                    "server prefills", qid, seg.get("seq"), dest, e,
                )
            return False

        return worker._pool().submit(push)


def make_segment_transport(
    name: str, worker: "GenerationServerWorker"
) -> SegmentTransport:
    """The segment transport ``name`` for ``worker``.  ``tpu-d2d`` is a
    recognised capability with no backend, so asking for it is a
    configuration error, not a silent fallback that would mislead the
    fleet's directory."""
    if name == "host-numpy":
        return HostNumpyTransport(worker)
    if name in SEGMENT_TRANSPORTS:
        raise ValueError(
            f"segment transport {name!r} has no backend in this build"
        )
    raise ValueError(
        f"unknown segment transport {name!r}; expected one of "
        f"{SEGMENT_TRANSPORTS}"
    )


def _check_config(config: system_api.GenServerConfig):
    """Refuse, before anything is built, what the port does not serve."""
    role = config.role or "unified"
    if role not in SERVER_ROLES:
        raise ValueError(
            f"unknown server role {role!r}; expected prefill | decode | unified"
        )
    make_segment_transport(config.segment_transport or "host-numpy", None)
    if config.num_processes > 1:
        raise _not_ported(
            f"multi-process serving (num_processes={config.num_processes})",
            item=10,
        )
    if config.world_size > 1:
        raise _not_ported(
            f"serving on a mesh of {config.world_size} devices", item=10
        )


class GenerationServerWorker(worker_base.Worker):
    def _configure(self, config: system_api.GenServerConfig):
        _check_config(config)
        self.config = config
        self.worker_name = config.worker_name
        self.logger = logging_.getLogger(self.worker_name)

        from areal_tpu_torch.engine.backend import make_model
        from areal_tpu_torch.engine.dispatch import resolve_dispatch_table
        from areal_tpu_torch.engine.inference_server import (
            ContinuousBatchingEngine,
        )
        from areal_tpu_torch.engine.sampling import SamplingParams
        from areal_tpu_torch.engine.spec_decode import resolve_spec_params
        from areal_tpu_torch.observability import get_registry, tracing
        from areal_tpu_torch.observability.latency import SLO_BUCKETS

        # configure BEFORE the engine is built: the engine binds the
        # process tracer at construction
        tracing.configure(config.trace, worker=config.worker_name)
        tokenizer = None
        if config.tokenizer_path:
            tokenizer = dataset_api.load_hf_tokenizer(config.tokenizer_path)
        device = config.device
        if device is None and config.device_idx is not None:
            device = f"cuda:{config.device_idx}"
        # the serving role the manager routes by; the handoff itself is
        # driven per request by the ``handoff_to`` metadata
        self._role = config.role or "unified"
        self._transport_name = config.segment_transport or "host-numpy"
        self._segment_transport = make_segment_transport(
            self._transport_name, self
        )
        model = make_model(config.model, None, None, tokenizer=tokenizer,
                           device=device)
        self.engine = ContinuousBatchingEngine(
            model.model_cfg,
            model.init_params,
            tokenizer=tokenizer,
            max_batch=config.max_concurrent_batch,
            kv_cache_len=config.kv_cache_len,
            chunk_size=config.chunk_size,
            sampling=SamplingParams(
                temperature=config.temperature, greedy=config.greedy
            ),
            device=device,
            cache_mode=config.cache_mode,
            page_size=config.page_size,
            kv_pool_tokens=config.kv_pool_tokens,
            kv_cache_dtype=config.kv_cache_dtype,
            serving_weight_dtype=config.serving_weight_dtype,
            prefill_chunk_tokens=config.prefill_chunk_tokens,
            pipeline_depth=config.pipeline_depth,
            dispatch_table=resolve_dispatch_table(
                config.paged_min_cache_len, config.deep_kernel_min_context
            ),
            prefix_cache=config.prefix_cache,
            prefix_cache_capacity_frac=config.prefix_cache_capacity_frac,
            prefix_cache_min_tokens=config.prefix_cache_min_match_tokens,
            prefix_cache_host_bytes=config.prefix_cache_host_bytes,
            spec_decode_params=resolve_spec_params(config.spec_decode),
            slo_tracking=config.slo_tracking,
            server_name=config.worker_name,
            handoff_streaming=config.handoff_streaming,
            prefix_pull_min_tokens=config.prefix_pull_min_tokens,
        )
        del model

        self._ctx = zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.ROUTER)
        port = self._sock.bind_to_random_port("tcp://*")
        self.addr = f"{network.gethostip()}:{port}"
        expr, tr = constants.experiment_name(), constants.trial_name()
        name_resolve.add(
            names.gen_server(expr, tr, config.worker_name),
            format_server_registration(
                self.addr, config.mesh_spec, role=self._role,
                transport=self._transport_name,
            ),
            replace=True,
        )
        # qid -> ROUTER identity awaiting the result
        self._waiting: Dict[str, bytes] = {}
        # token streams opened, whose submit may not have been applied yet
        # (a stream_poll can come before the generate_stream's batch)
        self._open_streams: set = set()
        self._update_reply_idents = []  # clients awaiting update_weights
        self._import_reply_idents = []  # clients awaiting import_handoff
        self._segment_reply_idents = []  # ... import_handoff_segment
        # P/D handoff: the decode server of each handoff request, peer
        # clients made on first use, and the pushes in flight on a small
        # thread pool (a slow or dead peer never stalls the poll loop; the
        # client's reply waits for the push, bounded by the RPC's timeout)
        self._handoff_dest: Dict[str, str] = {}
        self._peer_clients: Dict[str, "GenServerClient"] = {}
        self._handoff_pool = None
        self._handoff_futs: Dict[str, object] = {}
        self._handoff_out: Dict[str, object] = {}
        # the streamed handoff: segments queued per stream and pushed in
        # order, one in flight a stream; the reply to a handoff request
        # waits for its final segment's push ("gate"); a failed push drops
        # the stream's remainder (the peer's TTL frees its blocks)
        self._handoff_streaming = bool(config.handoff_streaming)
        self._stream_push: Dict[str, Dict] = {}
        # peer prefix pulls in flight: the owner's export_prefix RPC runs
        # on the same pool and its segments come back as commands
        self._pull_futs: Dict[str, object] = {}
        # the in-flight staged restore (update_weights mode="stage"): a
        # background thread restores the snapshot into a staged tree while
        # decode continues; its reply is deferred until the tree is on the
        # device (the manager's pre-pause barrier)
        self._staging: Optional[Dict] = None
        self._start_time = time.monotonic()
        self._compile_watch = self._make_compile_watch(config)

        # the engine keeps plain cumulative counters; the worker mirrors
        # them into the registry as counter deltas and gauges each poll
        reg = get_registry()
        self._registry = reg
        self._obs = {
            "chunks": reg.counter("areal_inference_chunks_total"),
            "gen_tokens": reg.counter("areal_inference_generated_tokens_total"),
            "prefill_tokens": reg.counter("areal_inference_prefill_tokens_total"),
            "prefix_hits": reg.counter("areal_inference_prefix_cache_hits_total"),
            "prefix_misses": reg.counter(
                "areal_inference_prefix_cache_misses_total"
            ),
            "prefix_cached_tokens": reg.counter(
                "areal_inference_prefix_cached_tokens_total"
            ),
            "prefix_evictions": reg.counter(
                "areal_inference_prefix_cache_evictions_total"
            ),
            "kv_quant_checks": reg.counter(
                "areal_inference_kv_quant_divergence_checks_total"
            ),
            "kv_quant_diverged": reg.counter(
                "areal_inference_kv_quant_divergence_diverged_total"
            ),
            "weight_quant_checks": reg.counter(
                "areal_inference_weight_quant_divergence_checks_total"
            ),
            "weight_quant_diverged": reg.counter(
                "areal_inference_weight_quant_divergence_diverged_total"
            ),
            "prefix_host_spilled": reg.counter(
                "areal_inference_prefix_host_spilled_blocks_total"
            ),
            "prefix_host_restored": reg.counter(
                "areal_inference_prefix_host_restored_blocks_total"
            ),
            "prefix_host_dropped": reg.counter(
                "areal_inference_prefix_host_dropped_blocks_total"
            ),
            "spec_drafted": reg.counter(
                "areal_inference_spec_draft_tokens_total"
            ),
            "spec_accepted": reg.counter(
                "areal_inference_spec_accepted_tokens_total"
            ),
            "spec_rejected": reg.counter(
                "areal_inference_spec_rejected_tokens_total"
            ),
            "spec_verify_chunks": reg.counter(
                "areal_inference_spec_verify_chunks_total"
            ),
            "spec_fallback_rows": reg.counter(
                "areal_inference_spec_fallback_rows_total"
            ),
            "swap_stage": reg.counter("areal_inference_swap_stage_seconds_total"),
            "swap_pause": reg.counter("areal_inference_swap_pause_seconds_total"),
            "swaps": reg.counter("areal_inference_weight_swaps_total"),
            "swaps_staged": reg.counter(
                "areal_inference_weight_swaps_staged_total"
            ),
            "handoff_exports": reg.counter(
                "areal_inference_handoff_exports_total"
            ),
            "handoff_imports": reg.counter(
                "areal_inference_handoff_imports_total"
            ),
            "handoff_bytes": reg.counter("areal_inference_handoff_bytes_total"),
            "handoff_seconds": reg.counter(
                "areal_inference_handoff_seconds_total"
            ),
            "handoff_segment_exports": reg.counter(
                "areal_inference_handoff_segment_exports_total"
            ),
            "handoff_segment_imports": reg.counter(
                "areal_inference_handoff_segment_imports_total"
            ),
            "handoff_segment_aborts": reg.counter(
                "areal_inference_handoff_segment_aborts_total"
            ),
            "prefix_peer_pulls": reg.counter(
                "areal_inference_prefix_peer_pulls_total"
            ),
            "prefix_peer_pull_bytes": reg.counter(
                "areal_inference_prefix_peer_pull_bytes_total"
            ),
            "inflight": reg.gauge("areal_inference_inflight_rows"),
            "pending": reg.gauge("areal_inference_pending_requests"),
            "version": reg.gauge("areal_inference_weight_version"),
            "ring_depth": reg.gauge("areal_inference_ring_depth"),
            "inflight_chunks": reg.gauge("areal_inference_inflight_chunks"),
            "prefix_blocks": reg.gauge("areal_inference_prefix_cache_blocks"),
            "kv_quant_bits": reg.gauge("areal_inference_kv_quant_storage_bits"),
            "kv_quant_blocks": reg.gauge("areal_inference_kv_quant_blocks"),
            "weight_quant_bits": reg.gauge(
                "areal_inference_weight_quant_storage_bits"
            ),
            "weight_quant_leaves": reg.gauge(
                "areal_inference_weight_quant_leaves"
            ),
            "prefix_host_bytes": reg.gauge("areal_inference_prefix_host_bytes"),
            "prefix_host_blocks": reg.gauge(
                "areal_inference_prefix_host_blocks"
            ),
            "mesh_devices": reg.gauge("areal_inference_mesh_devices"),
        }
        self._obs_spec_accept = reg.histogram(
            "areal_inference_spec_accept_rate",
            buckets=(0.0, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0),
        )
        self._obs_preempt_class = reg.counter("areal_gateway_preemptions_total")
        self._obs_preempt_class_last: Dict[str, int] = {}
        # handoff import rejects and failed prefix pulls, by reason
        self._obs_handoff_rejects = reg.counter(
            "areal_inference_handoff_import_rejects_total"
        )
        self._obs_handoff_rejects_last: Dict[str, int] = {}
        self._obs_pull_rejects = reg.counter(
            "areal_inference_prefix_peer_pull_rejects_total"
        )
        self._obs_pull_rejects_last: Dict[str, int] = {}
        # request-level SLO digests as histograms over the fixed buckets
        self._obs_slo = {
            "admission_wait_s": reg.histogram(
                "areal_slo_admission_wait_seconds", buckets=SLO_BUCKETS
            ),
            "ttft_s": reg.histogram("areal_slo_ttft_seconds", buckets=SLO_BUCKETS),
            "tpot_s": reg.histogram("areal_slo_tpot_seconds", buckets=SLO_BUCKETS),
            "stall_s": reg.histogram(
                "areal_slo_stall_seconds", buckets=SLO_BUCKETS
            ),
        }
        self._obs_last: Dict[str, float] = {}

    def _make_compile_watch(self, config):
        """The compile watch over the engine's kernel entries: the paged
        fill and decode chunks (``models/paged.py``), or the dense decode
        chunk and admission prefill (``models/transformer.py``), each by
        the libraries it launches.  A steady-state load
        force-samples every in-flight row's trace root."""
        from areal_tpu_torch.observability.compile_watch import (
            CompileWatch,
            library_entry,
        )
        from areal_tpu_torch.observability.tracing import member_root

        eng = self.engine

        def _force_inflight_roots(fns):
            for row in eng.rows:
                if row is not None:
                    eng.tracer.force(member_root(row.req.qid))

        watch = CompileWatch(
            quiet_after_steps=config.compile_quiet_after_steps,
            on_steady_compile=_force_inflight_roots,
        )
        if eng.paged:
            def _paged_sig():
                return (f"page={eng.page_size},chunk={eng.chunk_size},"
                        f"n_blocks={eng.n_blocks},batch={eng.max_batch}")

            watch.watch("paged_fill_chunk", library_entry("paged_attention"),
                        signature=_paged_sig)
            watch.watch("paged_decode_chunk", library_entry(
                "paged_attention", "paged_attention_deep"),
                signature=_paged_sig)
        else:
            def _dense_sig():
                return (f"cache_len={eng.kv_cache_len},"
                        f"chunk={eng.chunk_size},batch={eng.max_batch}")

            # the dense decode chunk's attention is flash_decode (the deep
            # library's entry); an admission's prefill runs the flash kernel
            watch.watch("decode_chunk", library_entry("paged_attention_deep"),
                        signature=_dense_sig)
            watch.watch("admit_rows", library_entry("flash_attention"),
                        signature=_dense_sig)
        return watch

    def _export_engine_metrics(self):
        eng = self.engine
        pstats = eng.prefix_cache_stats()
        qstats = eng.kv_quant_stats()
        wstats = eng.weight_quant_stats()
        sstats = eng.spec_stats()
        hstats = eng.handoff_stats()
        fstats = eng.prefix_peer_stats()
        totals = {
            "chunks": float(eng.decode_chunks_total),
            "gen_tokens": float(eng.gen_tokens_total),
            "prefill_tokens": float(eng.prefill_tokens_total),
            "prefix_hits": float(pstats["hits_total"]),
            "prefix_misses": float(pstats["misses_total"]),
            "prefix_cached_tokens": float(pstats["cached_tokens_total"]),
            "prefix_evictions": float(pstats["evictions_total"]),
            "kv_quant_checks": float(qstats["divergence_checks_total"]),
            "kv_quant_diverged": float(qstats["divergence_diverged_total"]),
            "weight_quant_checks": float(wstats["divergence_checks_total"]),
            "weight_quant_diverged": float(
                wstats["divergence_diverged_total"]
            ),
            "prefix_host_spilled": float(pstats["spilled_blocks_total"]),
            "prefix_host_restored": float(pstats["restored_blocks_total"]),
            "prefix_host_dropped": float(
                pstats["host_dropped_blocks_total"]
            ),
            "spec_drafted": float(sstats["drafted_total"]),
            "spec_accepted": float(sstats["accepted_total"]),
            "spec_rejected": float(sstats["rejected_total"]),
            "spec_verify_chunks": float(sstats["verify_chunks_total"]),
            "spec_fallback_rows": float(sstats["fallback_rows_total"]),
            "swap_stage": eng.swap_stage_s,
            "swap_pause": eng.swap_pause_s,
            "swaps": float(eng.swaps_total),
            "swaps_staged": float(eng.swaps_staged_total),
            "handoff_exports": float(hstats["exports_total"]),
            "handoff_imports": float(hstats["imports_total"]),
            "handoff_bytes": float(hstats["bytes_total"]),
            "handoff_seconds": float(hstats["seconds_total"]),
            "handoff_segment_exports": float(hstats["segment_exports_total"]),
            "handoff_segment_imports": float(hstats["segment_imports_total"]),
            "handoff_segment_aborts": float(hstats["segment_aborts_total"]),
            "prefix_peer_pulls": float(fstats["pulls_total"]),
            "prefix_peer_pull_bytes": float(fstats["pull_bytes_total"]),
        }
        for key, total in totals.items():
            delta = total - self._obs_last.get(key, 0.0)
            if delta > 0:
                self._obs[key].inc(delta)
                self._obs_last[key] = total
        for counter, last, by_reason in (
            (self._obs_handoff_rejects, self._obs_handoff_rejects_last,
             hstats["import_rejects"]),
            (self._obs_pull_rejects, self._obs_pull_rejects_last,
             fstats["pull_rejects"]),
        ):
            for reason, total in by_reason.items():
                delta = total - last.get(reason, 0)
                if delta > 0:
                    counter.inc(delta, reason=reason)
                    last[reason] = total
        for cls, total in eng.preempted_by_class.items():
            delta = total - self._obs_preempt_class_last.get(cls, 0)
            if delta > 0:
                # "class" is a Python keyword: pass the label via **
                self._obs_preempt_class.inc(delta, **{"class": cls})
                self._obs_preempt_class_last[cls] = total
        for rec in eng.drain_slo_records():
            w = rec.workload
            self._obs_slo["admission_wait_s"].observe(
                rec.admission_wait_s, workload=w
            )
            self._obs_slo["ttft_s"].observe(rec.ttft_s, workload=w)
            self._obs_slo["stall_s"].observe(rec.stall_s, workload=w)
            if rec.tpot_s is not None:
                self._obs_slo["tpot_s"].observe(rec.tpot_s, workload=w)
        self._obs["inflight"].set(eng.n_inflight)
        self._obs["pending"].set(eng.n_pending)
        self._obs["version"].set(eng.version)
        self._obs["ring_depth"].set(eng.pipeline_depth)
        self._obs["inflight_chunks"].set(eng.inflight_chunks)
        self._obs["prefix_blocks"].set(pstats["blocks_held"])
        self._obs["kv_quant_bits"].set(qstats["storage_bits"])
        self._obs["kv_quant_blocks"].set(qstats["quantized_blocks_held"])
        self._obs["weight_quant_bits"].set(wstats["storage_bits"])
        self._obs["weight_quant_leaves"].set(wstats["quantized_leaves"])
        self._obs["prefix_host_bytes"].set(pstats["host_bytes_held"])
        self._obs["prefix_host_blocks"].set(pstats["host_blocks_held"])
        for frac in eng.drain_spec_accept_samples():
            self._obs_spec_accept.observe(frac)
        self._obs["mesh_devices"].set(eng.mesh_devices)
        # the HBM ledger's bytes and peaks, per subsystem
        eng.hbm_ledger.publish(self._registry)
        # the compile watch: arm it off the engine's step clock, then diff
        # the watched entries (counts, spans, and the sentinel when armed)
        self._compile_watch.note_step(eng._step_seq)
        self._compile_watch.poll()

    # -- API ---------------------------------------------------------------

    def _serve_api(self):
        """Drain client requests into an ordered command batch.  Read-only
        queries are answered at once; state-changing commands are returned
        to be applied before the engine steps."""
        batch = []
        for _ in range(64):
            try:
                ident, _, msg = self._sock.recv_multipart(flags=zmq.NOBLOCK)
            except zmq.ZMQError:
                break
            try:
                cmd, payload = pickle.loads(msg)
                if cmd == "generate":
                    self._waiting[payload.qid] = ident
                    dest = (payload.metadata or {}).get("handoff_to")
                    if dest:
                        # a prefill-stage request: its KV goes to this
                        # decode server before the reply (_reply_finished)
                        self._handoff_dest[payload.qid] = dest
                    batch.append((cmd, payload))
                    continue  # reply when the result is ready
                elif cmd == "generate_stream":
                    # acknowledged at once; the submit rides the batch with
                    # the stream flag, and the result stays with the engine
                    # for stream_poll (no _waiting entry)
                    md = dict(payload.metadata or {})
                    md["stream"] = True
                    payload.metadata = md
                    self._open_streams.add(payload.qid)
                    batch.append(("generate", payload))
                    resp = {"ok": True, "qid": payload.qid}
                elif cmd == "stream_poll":
                    # a read, answered at once like ``metrics``
                    resp = self._stream_poll(payload)
                elif cmd == "stream_cancel":
                    # releases the row's pool blocks: applied in the batch
                    self._open_streams.discard(payload["qid"])
                    batch.append((cmd, payload))
                    resp = {"ok": True}
                elif cmd == "update_weights":
                    self._update_reply_idents.append(ident)
                    batch.append((cmd, payload))
                    continue  # reply after the apply
                elif cmd == "pause":
                    batch.append((cmd, payload))
                    resp = "paused"
                elif cmd == "resume":
                    batch.append((cmd, payload))
                    resp = "resumed"
                elif cmd == "metrics":
                    resp = self.metrics()
                elif cmd == "import_handoff":
                    # a pool scatter: applied in the batch, replied after
                    self._import_reply_idents.append(ident)
                    batch.append((cmd, payload))
                    continue
                elif cmd == "import_handoff_segment":
                    self._segment_reply_idents.append(ident)
                    batch.append((cmd, payload))
                    continue
                elif cmd == "export_prefix":
                    # the owner's side of a pull: a gather, answered at
                    # once like ``metrics`` (no engine state changes)
                    resp = self._export_prefix(payload)
                else:
                    resp = {"error": f"unknown command {cmd}"}
            except Exception as e:  # noqa: BLE001
                self.logger.exception("api request failed")
                resp = {"error": repr(e)}
            self._sock.send_multipart([ident, b"", pickle.dumps(resp)])
        return batch

    def _apply_commands(self, batch):
        """Apply one command batch to the engine, in order."""
        for cmd, payload in batch:
            if cmd == "generate":
                try:
                    self.engine.submit(payload)
                except Exception as e:  # noqa: BLE001 - reported to the client
                    self.logger.exception("generate refused")
                    ident = self._waiting.pop(payload.qid, None)
                    if ident is None:
                        # a stream: its next poll finds no stream
                        self._open_streams.discard(payload.qid)
                        continue
                    self._sock.send_multipart(
                        [ident, b"", pickle.dumps({"error": repr(e)})]
                    )
            elif cmd == "update_weights":
                mode = payload.get("mode") or "full"
                if mode == "stage":
                    # deferred reply: the stage RPC answers once the staged
                    # tree is on the device (see _reply_staged)
                    self._begin_stage(payload)
                    continue
                try:
                    if mode == "commit":
                        n = self._commit_staged(payload)
                    else:
                        n = self._update_weights(payload)
                    resp = {"num_interrupted": n, "version": self.engine.version}
                except Exception as e:  # noqa: BLE001
                    self.logger.exception("weight update failed")
                    resp = {"error": repr(e)}
                if self._update_reply_idents:
                    ident = self._update_reply_idents.pop(0)
                    self._sock.send_multipart([ident, b"", pickle.dumps(resp)])
            elif cmd in ("import_handoff", "import_handoff_segment"):
                try:
                    if cmd == "import_handoff":
                        ok, reason = self.engine.import_handoff(payload["unit"])
                    else:
                        ok, reason = self.engine.import_handoff_segment(
                            payload["segment"])
                    resp = {"imported": ok, "reason": reason}
                except Exception as e:  # noqa: BLE001 - the peer prefills
                    self.logger.exception("%s failed", cmd)
                    resp = {"error": repr(e)}
                idents = (self._import_reply_idents if cmd == "import_handoff"
                          else self._segment_reply_idents)
                if idents:
                    self._sock.send_multipart(
                        [idents.pop(0), b"", pickle.dumps(resp)])
            elif cmd == "import_prefix_segment":
                # one pulled segment (the engine fails closed on any skew
                # and the admission prefills)
                try:
                    self.engine.import_prefix_segment(payload["segment"])
                except Exception:  # noqa: BLE001 - fail closed
                    self.logger.exception("prefix segment import failed")
            elif cmd == "prefix_pull_failed":
                self.engine.prefix_pull_failed(payload["qid"])
            elif cmd == "stream_cancel":
                self.engine.cancel(payload["qid"])
            elif cmd == "pause":
                self.engine.pause()
            elif cmd == "resume":
                self.engine.resume()

    def _reply_finished(self):
        # a settled monolithic push frees its request's reply
        for qid in list(self._handoff_futs):
            if not self._handoff_futs[qid].done():
                continue
            del self._handoff_futs[qid]
            out = self._handoff_out.pop(qid)
            self._sock.send_multipart(
                [self._waiting.pop(qid), b"", pickle.dumps(out)])
        for qid in list(self._waiting):
            if qid in self._handoff_futs:
                continue  # the reply waits for the push
            st = self._stream_push.get(qid)
            if st is not None and st["gate"]:
                # the final segment is queued or in flight: reply once it
                # settles, so the continuation cannot overtake the park on
                # the decode server
                continue
            out = self.engine.try_get_result(qid)
            if out is not None:
                dest = self._handoff_dest.pop(qid, None)
                if (dest is not None and not self._handoff_streaming
                        and out.no_eos and out.output_ids
                        and self._begin_handoff(qid, dest, out)):
                    continue
                ident = self._waiting.pop(qid)
                self._sock.send_multipart([ident, b"", pickle.dumps(out)])

    def _begin_handoff(self, qid: str, dest: str, out) -> bool:
        """Export the parked row's KV (on the poll thread, the engine's)
        and start the ``import_handoff`` push to ``dest`` on the handoff
        pool.  True when a push is in flight (the reply waits for it).
        Every failure is closed: the peer rejects a skewed unit, a dead one
        times out, and the continuation prefills on the decode server."""
        unit = self.engine.export_handoff(qid)
        if unit is None:
            return False  # released by a swap or the TTL: the peer prefills
        client = self._peer_client(dest)

        def push():
            try:
                resp = client.call("import_handoff", {"unit": unit},
                                   timeout=self.config.handoff_request_timeout)
                if not (isinstance(resp, dict) and resp.get("imported")):
                    self.logger.warning(
                        "handoff of %s rejected by %s (%s); the decode "
                        "server prefills", qid, dest,
                        resp.get("reason") if isinstance(resp, dict) else resp,
                    )
            except Exception as e:  # noqa: BLE001 - fail closed
                self.logger.warning(
                    "handoff of %s to %s failed (%r); the decode server "
                    "prefills", qid, dest, e,
                )

        self._handoff_out[qid] = out
        self._handoff_futs[qid] = self._pool().submit(push)
        return True

    # -- the streamed handoff and the prefix pulls ----------------------------

    def _pool(self):
        if self._handoff_pool is None:
            import concurrent.futures as cf

            self._handoff_pool = cf.ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="kv-handoff"
            )
        return self._handoff_pool

    def _peer_client(self, dest: str) -> "GenServerClient":
        """The RPC client of a peer server, made on first use."""
        if dest not in self._peer_clients:
            self._peer_clients[dest] = GenServerClient(
                dest, timeout=self.config.handoff_request_timeout
            )
        return self._peer_clients[dest]

    def _submit_segment_push(self, qid: str, st: Dict, seg: Dict):
        """Push ONE segment over the server's segment transport; returns
        its future (bool ok)."""
        return self._segment_transport.submit(
            qid, seg.get("dest") or st["dest"], seg)

    def _export_prefix(self, payload: Dict) -> Dict:
        """The owner's side of a peer pull: the longest cached full-block
        prefix of the peer's tokens as numbered segments."""
        try:
            segs = self.engine.export_prefix(payload.get("qid", "?"),
                                             payload.get("tokens") or [])
        except Exception as e:  # noqa: BLE001 - the puller prefills
            self.logger.exception("prefix export failed")
            return {"segments": [], "reason": repr(e)}
        if not segs:
            return {"segments": [], "reason": "miss"}
        return {"segments": segs}

    def _pump_prefix_pulls(self):
        """Start the owner's ``export_prefix`` RPC for each pull the engine
        registered, on the handoff pool (a dead or slow owner never stalls
        the poll loop; the engine's TTL bounds the requeued admission's
        wait).  Each resolves to the owner's segments, or to None on any
        failure (the pull fails closed)."""
        for req in self.engine.drain_prefix_pull_requests():
            qid, source = req["qid"], req["source"]
            client = self._peer_client(source)
            timeout = self.config.handoff_request_timeout
            log = self.logger

            def pull(qid=qid, source=source, tokens=req["tokens"],
                     client=client):
                try:
                    resp = client.call("export_prefix",
                                       {"qid": qid, "tokens": tokens},
                                       timeout=timeout)
                    segs = (resp.get("segments") if isinstance(resp, dict)
                            else None)
                    if segs:
                        return segs
                    log.info(
                        "prefix pull %s from %s returned nothing (%s); "
                        "prefilling locally", qid, source,
                        resp.get("reason") if isinstance(resp, dict) else resp,
                    )
                except Exception as e:  # noqa: BLE001 - fail closed
                    log.warning("prefix pull %s from %s failed (%r); "
                                "prefilling locally", qid, source, e)
                return None

            self._pull_futs[qid] = self._pool().submit(pull)

    def _drain_pull_commands(self):
        """Settled pulls as commands for this poll's batch: the owner's
        segments in order, or one failure."""
        cmds = []
        for qid in list(self._pull_futs):
            fut = self._pull_futs[qid]
            if not fut.done():
                continue
            del self._pull_futs[qid]
            segs = fut.result()
            if segs:
                cmds.extend(("import_prefix_segment", {"segment": seg})
                            for seg in segs)
            else:
                cmds.append(("prefix_pull_failed", {"qid": qid}))
        return cmds

    def _pump_handoff_streams(self):
        """Each poll: queue the engine's new segments per stream, settle
        finished pushes, and keep one push in flight a stream (segments
        must arrive in order; a failure drops the stream's remainder, the
        decode side's TTL frees its blocks and the continuation prefills
        there)."""
        for seg in self.engine.drain_handoff_segments():
            st = self._stream_push.setdefault(seg["qid"], {
                "queue": deque(), "fut": None, "failed": False,
                "gate": False, "dest": seg.get("dest"),
            })
            if seg.get("final"):
                st["gate"] = True  # the client's reply waits for this one
            if not st["failed"]:
                st["queue"].append(seg)
        for qid in list(self._stream_push):
            st = self._stream_push[qid]
            fut = st["fut"]
            if fut is not None:
                if not fut.done():
                    continue
                st["fut"] = None
                if not fut.result():
                    st["failed"] = True
                    st["queue"].clear()
            if st["queue"]:
                st["fut"] = self._submit_segment_push(
                    qid, st, st["queue"].popleft())
            else:
                # drained or failed: dropping the record opens the reply
                # gate; a stream still filling makes a new one
                del self._stream_push[qid]

    def _update_weights(self, payload: Dict) -> int:
        """Restore new weights and hot-swap them (the full-reload path: the
        restore runs on the poll thread, inside any fleet pause).  The
        staged protocol (``mode="stage"`` then ``mode="commit"``) moves all
        but the pointer flip off that path."""
        params = self._load_update_params(payload, staged=False)
        return self.engine.update_weights(params, version=payload.get("version"))

    # -- staged weight sync (stage -> commit) --------------------------------

    def _negotiate_weight_format(
        self, path: str, manifest: Optional[Dict]
    ) -> Tuple[str, str, Optional[Dict]]:
        """``(format, restore_path, quant_leaves)`` of the snapshot tree
        this server restores, format ``"int8"`` or ``"full"``.  A server
        with ``serving_weight_dtype="int8"`` takes the int8 sibling tree
        the publisher advertised in the manifest (about half the bytes to
        stage); a publisher that wrote none, a snapshot without a manifest
        or an advertised tree that is gone falls back to the full tree,
        with one log line, quantized on arrival.  An ``"auto"`` server
        ignores the advertisement."""
        if self.config.serving_weight_dtype != "int8":
            return "full", path, None
        qinfo = ((manifest or {}).get("serving_quant") or {}).get("int8")
        if not (isinstance(qinfo, dict) and qinfo.get("dir")):
            self.logger.info(
                "serving_weight_dtype='int8' but snapshot %s advertises no "
                "int8 serving tree%s: restoring the full-precision tree and "
                "quantizing it on arrival", path,
                "" if manifest is not None else " (no manifest)",
            )
            return "full", path, None
        qpath = os.path.join(
            os.path.dirname(os.path.abspath(path)), qinfo["dir"]
        )
        if not os.path.isdir(qpath):
            self.logger.info(
                "the advertised int8 serving tree %s is gone: restoring the "
                "full-precision tree and quantizing it on arrival", qpath,
            )
            return "full", path, None
        return "int8", qpath, qinfo.get("leaves")

    def _load_update_params(self, payload: Dict, staged: bool):
        """Restore the snapshot named by an update payload.  The staged
        path first checks the publisher's layout manifest against the
        engine's tree, so a layout mismatch fails as one readable error
        before any tensor is read, then restores through at most
        ``stage_chunk_bytes`` of host buffers straight onto the engine's
        device."""
        path = payload.get("path")
        if payload.get("format") != "params":
            return self.engine.prepare_weights(self._load_hf_dir(path, staged))
        from areal_tpu_torch.engine import checkpoint

        manifest = checkpoint.read_manifest(path)
        fmt, restore_path, quant_leaves = self._negotiate_weight_format(
            path, manifest
        )
        template = self.engine.weight_restore_template(fmt)
        if not staged:
            return self.engine.prepare_weights(
                checkpoint.load_params_like(template, restore_path)
            )
        # the layout check of the tree this restore reads: the int8 tree's
        # own leaves, or the manifest's
        leaves = quant_leaves if fmt == "int8" else (manifest or {}).get(
            "leaves"
        )
        if leaves:
            problems = checkpoint.validate_manifest(template, {"leaves": leaves})
            if problems:
                raise RuntimeError(
                    "published snapshot does not match this engine's "
                    f"layout: {problems[:3]}"
                )
        with self.engine.stage_context():
            restored = checkpoint.load_params_staged(
                template, restore_path, chunk_bytes=self.config.stage_chunk_bytes
            )
        return self.engine.prepare_weights(restored)

    def _load_hf_dir(self, path: str, staged: bool):
        """An HF checkpoint directory's weights as a serving copy on the
        engine's device (inside the stage stream when ``staged``).  Its
        ``config.json`` must describe the served architecture; that is
        checked before any tensor is read."""
        from areal_tpu_torch.models.convert import serving_params
        from areal_tpu_torch.models.hf.registry import (
            load_hf_config,
            load_hf_model,
        )

        _, cfg, _ = load_hf_config(path)
        mine, theirs = (dataclasses.asdict(c) for c in (self.engine.cfg, cfg))
        diff = [f"{k} {theirs[k]!r} (served {mine[k]!r})" for k in mine
                if k not in _RUN_OPTIONS and mine[k] != theirs[k]]
        if diff:
            raise RuntimeError(
                f"HF checkpoint {path} is not the served architecture: "
                + ", ".join(diff))
        with (self.engine.stage_context() if staged
              else contextlib.nullcontext()):
            _, params = load_hf_model(path, device=self.engine.device)
            return serving_params(params, self.engine.cfg)

    def _begin_stage(self, payload: Dict):
        """Start restoring ``payload``'s snapshot into a staged tree on a
        background thread while decode continues.  :meth:`_reply_staged`
        answers once the tree is on the device or the restore failed."""
        ident = self._update_reply_idents.pop(0) if self._update_reply_idents \
            else None
        if self._staging is not None and not self._staging["done"].is_set():
            # a concurrent round is still restoring: a retry after a
            # timeout; fail fast (the manager re-polls the version)
            if ident is not None:
                self._sock.send_multipart([
                    ident, b"",
                    pickle.dumps({"error": "weight staging in progress"}),
                ])
            return
        # an aborted round may have left an uncommitted tree: drop it so
        # the commit barrier can never flip a stale version
        self.engine.discard_staged()
        rec: Dict = {
            "done": threading.Event(),
            "result": None,
            "ident": ident,
            "replied": False,
            "version": payload.get("version"),
            "t0": time.monotonic(),
        }
        rec["thread"] = threading.Thread(
            target=self._stage_worker,
            args=(payload, rec),
            daemon=True,
            name=f"weight-stage-v{payload.get('version')}",
        )
        self._staging = rec
        rec["thread"].start()

    def _stage_worker(self, payload: Dict, rec: Dict):
        # the restore as a flight-recorder span beside the decode chunks it
        # runs under (force-sampled: a swap is a fleet event)
        swap_root = f"swap-v{payload.get('version')}"
        tracer = self.engine.tracer
        tracer.force(swap_root)
        tracer.span_begin(
            swap_root, "swap.stage", root=swap_root,
            version=payload.get("version"),
        )
        eng = self.engine
        work0 = (eng.decode_steps_total, eng.decode_tokens_total)
        try:
            params = self._load_update_params(payload, staged=True)
            # the restored tree is a fresh serving copy nobody else holds
            eng.stage_weights(params, payload.get("version"), owned=True)
            rec["result"] = {
                "staged": payload.get("version"),
                "stage_seconds": round(time.monotonic() - rec["t0"], 4),
                # the decode work the poll loop did while this thread
                # restored: steps enqueued and tokens harvested.  A stage
                # that held the poll loop would show none
                "decode_steps_during_stage": eng.decode_steps_total - work0[0],
                "decode_tokens_during_stage": (
                    eng.decode_tokens_total - work0[1]
                ),
            }
            tracer.span_end(swap_root, "swap.stage", root=swap_root, ok=True)
        except Exception as e:  # noqa: BLE001 - reported to the manager
            self.logger.exception("weight staging failed")
            rec["result"] = {"error": repr(e)}
            tracer.span_end(
                swap_root, "swap.stage", root=swap_root, ok=False,
                error=repr(e),
            )
        finally:
            rec["done"].set()

    def _reply_staged(self):
        """Answer a finished stage RPC."""
        rec = self._staging
        if rec is None or rec["replied"] or not rec["done"].is_set():
            return
        rec["replied"] = True
        if rec["ident"] is not None:
            self._sock.send_multipart(
                [rec["ident"], b"", pickle.dumps(rec["result"])]
            )

    def _commit_staged(self, payload: Dict) -> int:
        """The version-consistent commit barrier: wait out a still-running
        staging, surface a failed restore, then hand the staged tree to the
        engine's next step.  A retry of a commit whose version is already
        applied or queued (its first reply was lost) is acknowledged."""
        rec = self._staging
        version = payload.get("version")
        if rec is not None:
            if not rec["done"].wait(
                timeout=float(payload.get("commit_timeout", 60.0))
            ):
                raise RuntimeError("staged restore still running at commit")
            self._reply_staged()  # never leave a stage RPC unanswered
            self._staging = None
            result = rec["result"]
            if isinstance(result, dict) and "error" in result:
                raise RuntimeError(f"staged restore failed: {result['error']}")
        if self.engine.staged_version is None and version is not None and (
            self.engine.version == version
            or self.engine.pending_version == version
        ):
            self.logger.info(
                "commit v%s retried after a lost reply: already applied",
                version,
            )
            return 0
        return self.engine.commit_staged(expected_version=version)

    def _stream_poll(self, payload: Dict) -> Dict:
        """One poll of a token stream: the tokens buffered since the last
        poll, and the final result (closing the stream) once the request
        finished."""
        qid = payload["qid"]
        eng = self.engine
        toks = eng.drain_stream(qid)
        out = eng.try_get_result(qid)
        if out is not None:
            extra = eng.drain_stream(qid)
            if extra:
                toks = (toks or []) + extra
            eng.stream_close(qid)
            self._open_streams.discard(qid)
            return {
                "tokens": toks or [],
                "done": True,
                "result": {
                    "output_ids": list(out.output_ids),
                    "output_logprobs": list(out.output_logprobs),
                    "no_eos": bool(out.no_eos),
                    "version_start": out.version_start,
                    "version_end": out.version_end,
                },
            }
        if toks is None:
            if qid in self._open_streams:
                # the generate_stream's batch is not applied yet
                return {"tokens": [], "done": False, "result": None}
            return {"error": f"unknown stream {qid}"}
        return {"tokens": toks, "done": False, "result": None}

    def metrics(self) -> Dict:
        eng = self.engine
        return {
            "n_inflight": eng.n_inflight,
            "n_pending": eng.n_pending,
            "gen_tokens_total": eng.gen_tokens_total,
            "version": eng.version,
            "uptime": time.monotonic() - self._start_time,
            "mesh_devices": eng.mesh_devices,
            "mesh_spec": ONE_DEVICE_SPEC,
            "ring_depth": eng.pipeline_depth,
            "inflight_chunks": eng.inflight_chunks,
            # the engine's work counters (fill chunks, decode chunks and
            # tokens), against which kernel launches are checked
            "prefill_calls": eng.prefill_calls,
            "one_token_fill_calls": eng.one_token_fill_calls,
            "prefill_tokens_total": eng.prefill_tokens_total,
            "decode_chunks_total": eng.decode_chunks_total,
            "deep_decode_chunks_total": eng.deep_decode_chunks_total,
            "decode_tokens_total": eng.decode_tokens_total,
            **{
                f"prefix_cache_{k}": v
                for k, v in eng.prefix_cache_stats().items()
            },
            **{f"kv_quant_{k}": v for k, v in eng.kv_quant_stats().items()},
            **{f"weight_quant_{k}": v
               for k, v in eng.weight_quant_stats().items()},
            **{f"spec_{k}": v for k, v in eng.spec_stats().items()},
            "cache_mode": "paged" if eng.paged else "dense",
            # P/D: the role, the prefill backlog the manager's admission
            # routes on, the handoff and prefix-pull counters
            "role": self._role,
            "prefill_backlog_tokens": eng.prefill_backlog_tokens(),
            **{f"handoff_{k}": v for k, v in eng.handoff_stats().items()},
            "segment_transport": self._transport_name,
            **{f"prefix_peer_{k}": v
               for k, v in eng.prefix_peer_stats().items()},
            **{f"swap_{k}": v for k, v in eng.swap_stats().items()},
            "slo": eng.slo_stats(),
            "slo_digests": eng.slo_digests(),
            "streams": eng.stream_stats(),
            "cancelled_total": eng.cancelled_total,
            "preempted_total": eng.preempted_total,
            "preempted_by_class": dict(eng.preempted_by_class),
            # the HBM ledger's bytes and peaks per subsystem (the
            # aggregator's merge_hbm folds the scraped gauges into fleet
            # rows) and the compile watch's counters
            "hbm_ledger": eng.hbm_ledger.snapshot(),
            "hbm_ledger_peak": eng.hbm_ledger.watermarks(),
            **self._compile_watch.stats(),
            # on a card, this process's own allocator's gauges
            **(monitor.device_memory_stats()
               if eng.device.type == "cuda" else {}),
        }

    # -- poll ---------------------------------------------------------------

    def _poll(self) -> worker_base.PollResult:
        batch = self._serve_api()
        # a stream nobody polled for stream_stale_steps engine steps (a
        # client gone) is cancelled in this batch
        for qid in self.engine.stale_stream_qids():
            self.logger.warning("cancelling stale token stream %s", qid)
            self._open_streams.discard(qid)
            batch.append(("stream_cancel", {"qid": qid}))
        # start the owner RPCs of new pulls; settled ones join this batch
        self._pump_prefix_pulls()
        batch.extend(self._drain_pull_commands())
        self._apply_commands(batch)
        eng = self.engine
        work0 = (eng.prefill_calls, eng.decode_chunks_total,
                 eng.spec_verify_chunks_total)
        n = eng.step()
        # new segments enter their queues (and gate their replies) before
        # the replies of this step's results go out
        self._pump_handoff_streams()
        self._reply_finished()
        self._reply_staged()
        self._export_engine_metrics()
        if not eng.inflight_chunks and work0 == (
                eng.prefill_calls, eng.decode_chunks_total,
                eng.spec_verify_chunks_total):
            self._idle_wait()
        return worker_base.PollResult(sample_count=n)

    def _idle_wait(self):
        """Wait up to ``IDLE_WAIT_S`` for a request on the socket or for a
        push, pull or stage of this server's to settle, in 2 ms slices, so
        an idle engine is not stepped (and its step clock not advanced)
        hundreds of times a second, and the poll thread leaves Python's
        lock to the threads that have work."""
        futs = [f for f in (list(self._handoff_futs.values())
                            + list(self._pull_futs.values())
                            + [st["fut"] for st in self._stream_push.values()])
                if f is not None]
        if any(f.done() for f in futs) or any(
                st["queue"] and st["fut"] is None
                for st in self._stream_push.values()):
            return
        staging = self._staging
        deadline = time.monotonic() + IDLE_WAIT_S
        while time.monotonic() < deadline:
            if self._sock.poll(timeout=2):
                return
            if any(f.done() for f in futs) or (
                    staging is not None and not staging["replied"]
                    and staging["done"].is_set()):
                return

    def _exit_hook(self):
        rec = getattr(self, "_staging", None)
        if rec is not None:
            rec["thread"].join()
        eng = getattr(self, "engine", None)
        if eng is not None:
            # the leak audit, then the release of the ledger attributions
            leaked = eng.close()
            self.exit_leak_audit = leaked
            if leaked:
                self.logger.warning("leak audit at exit: %s", leaked)
        watch = getattr(self, "_compile_watch", None)
        if watch is not None:
            watch.close()
        for client in getattr(self, "_peer_clients", {}).values():
            client.close()  # ends a push in flight promptly
        pool = getattr(self, "_handoff_pool", None)
        if pool is not None:
            pool.shutdown(wait=True)
        sock = getattr(self, "_sock", None)
        if sock is not None:
            sock.close(linger=0)


class GenServerClient:
    """Blocking client for the server API (one DEALER socket per thread,
    so one client serves concurrent requests)."""

    def __init__(self, addr: str, timeout: float = 600.0):
        self.addr = addr
        self.timeout = timeout
        self._ctx = zmq.Context.instance()
        self._local = threading.local()
        self._abort = threading.Event()

    def _sock(self) -> zmq.Socket:
        if not hasattr(self._local, "sock"):
            s = self._ctx.socket(zmq.DEALER)
            s.connect(f"tcp://{self.addr}")
            self._local.sock = s
        return self._local.sock

    def call(self, cmd: str, payload, timeout: Optional[float] = None) -> object:
        sock = self._sock()
        sock.send_multipart([b"", pickle.dumps((cmd, payload))])
        # sliced poll with an abort check, so close() unblocks a waiting
        # thread promptly
        if not _poll_abortable(
            sock, self.timeout if timeout is None else timeout, self._abort
        ):
            # discard the socket so a late reply cannot be read by (and
            # mismatched with) the next request on this thread
            sock.close(linger=0)
            del self._local.sock
            if self._abort.is_set():
                raise TimeoutError(f"{cmd} to {self.addr}: client closed")
            raise TimeoutError(f"{cmd} to {self.addr} timed out")
        _, msg = sock.recv_multipart()
        resp = pickle.loads(msg)
        if isinstance(resp, dict) and "error" in resp:
            raise RuntimeError(f"server error: {resp['error']}")
        return resp

    def generate(self, inp) -> object:
        return self.call("generate", inp)

    def close(self):
        self._abort.set()  # unblocks every waiting thread within ~0.5 s
        if hasattr(self._local, "sock"):
            self._local.sock.close(linger=0)


def _poll_abortable(
    sock: zmq.Socket, timeout_s: float, abort: threading.Event
) -> bool:
    """Poll in 0.5 s slices until data, timeout, or abort; True iff data."""
    deadline = time.monotonic() + timeout_s
    while not abort.is_set():
        left = deadline - time.monotonic()
        if left <= 0:
            return False
        if sock.poll(timeout=int(min(left, 0.5) * 1000)):
            return True
    return False
