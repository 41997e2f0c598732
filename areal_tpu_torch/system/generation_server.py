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
* ``("metrics", {})`` -> the engine's counters, swap times and SLO digests.

``format="params"`` names a snapshot that
:func:`areal_tpu_torch.engine.checkpoint.save_params` wrote; any other
format names an HF checkpoint directory of the served architecture
(``models/hf``).  A server with ``serving_weight_dtype="int8"`` restores
the int8 sibling tree a publisher advertises in the snapshot's manifest
(``serving_quant``), and otherwise the full tree, quantized on arrival
(:meth:`GenerationServerWorker._negotiate_weight_format`).  The config's
``spec_decode`` block, ``prefix_cache_host_bytes`` and ``cache_mode``
("dense" and "auto", which serves a sliding-window model such as Mistral
on the dense cache) pass to the engine.  Not ported yet, each refused
where a caller could ask for it: prefill/decode roles, segment transports
and the KV fabric (ROADMAP.md queue 1, item 8), multi-process servers and
meshes of more than one device (item 10), token streams, the compile watch
and the ``/metrics`` HTTP server (item 11).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import threading
import time
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
from areal_tpu_torch.engine.inference_server import _not_ported
from areal_tpu_torch.system import worker_base

#: serving roles a generation server may register under (only "unified"
#: is served by the port)
SERVER_ROLES = ("prefill", "decode", "unified")

#: segment transports a generation server may register
SEGMENT_TRANSPORTS = ("host-numpy", "tpu-d2d")

#: config fields an HF directory swapped into a server may differ in from
#: the served model's (how it runs, not what it computes on which shapes)
_RUN_OPTIONS = ("dtype", "logits_dtype", "remat", "remat_policy")

#: the mesh-spec field of a one-device registration (the JAX package's
#: default ``MeshSpec``, so registrations read the same in both packages)
ONE_DEVICE_SPEC = "d1f1m1p1s1e1"


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


def _check_config(config: system_api.GenServerConfig):
    """Refuse, before anything is built, what the port does not serve."""
    role = config.role or "unified"
    if role not in SERVER_ROLES:
        raise ValueError(
            f"unknown server role {role!r}; expected prefill | decode | unified"
        )
    if role != "unified":
        raise _not_ported(f"the {role!r} serving role (P/D handoff)", item=8)
    transport = config.segment_transport or "host-numpy"
    if transport not in SEGMENT_TRANSPORTS:
        raise ValueError(
            f"unknown segment transport {transport!r}; expected one of "
            f"{SEGMENT_TRANSPORTS}"
        )
    if transport != "host-numpy":
        raise ValueError(
            f"segment transport {transport!r} has no backend in this build"
        )
    if config.num_processes > 1:
        raise _not_ported(
            f"multi-process serving (num_processes={config.num_processes})",
            item=10,
        )
    if config.world_size > 1:
        raise _not_ported(
            f"serving on a mesh of {config.world_size} devices", item=10
        )
    if config.compile_quiet_after_steps > 0:
        raise _not_ported("the compile watch (compile_quiet_after_steps)",
                          item=11)


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
        self._role = "unified"
        self._transport_name = "host-numpy"
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
        )
        del model

        self._ctx = zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.ROUTER)
        port = self._sock.bind_to_random_port("tcp://*")
        self.addr = f"{network.gethostip()}:{port}"
        expr, tr = constants.experiment_name(), constants.trial_name()
        name_resolve.add(
            names.gen_server(expr, tr, config.worker_name),
            format_server_registration(self.addr, config.mesh_spec),
            replace=True,
        )
        # qid -> ROUTER identity awaiting the result
        self._waiting: Dict[str, bytes] = {}
        self._update_reply_idents = []  # clients awaiting update_weights
        # the in-flight staged restore (update_weights mode="stage"): a
        # background thread restores the snapshot into a staged tree while
        # decode continues; its reply is deferred until the tree is on the
        # device (the manager's pre-pause barrier)
        self._staging: Optional[Dict] = None
        self._start_time = time.monotonic()

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

    def _export_engine_metrics(self):
        eng = self.engine
        pstats = eng.prefix_cache_stats()
        qstats = eng.kv_quant_stats()
        wstats = eng.weight_quant_stats()
        sstats = eng.spec_stats()
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
        }
        for key, total in totals.items():
            delta = total - self._obs_last.get(key, 0.0)
            if delta > 0:
                self._obs[key].inc(delta)
                self._obs_last[key] = total
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
                    batch.append((cmd, payload))
                    continue  # reply when the result is ready
                elif cmd == "stream_cancel":
                    # releases the row's pool blocks: applied in the batch
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
                elif cmd in ("generate_stream", "stream_poll"):
                    raise _not_ported(f"token streams ({cmd!r})", item=11)
                elif cmd in ("import_handoff", "import_handoff_segment",
                             "export_prefix"):
                    raise _not_ported(
                        f"P/D handoff and the KV fabric ({cmd!r})", item=8
                    )
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
                    ident = self._waiting.pop(payload.qid)
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
            elif cmd == "stream_cancel":
                self.engine.cancel(payload["qid"])
            elif cmd == "pause":
                self.engine.pause()
            elif cmd == "resume":
                self.engine.resume()

    def _reply_finished(self):
        for qid in list(self._waiting):
            out = self.engine.try_get_result(qid)
            if out is not None:
                ident = self._waiting.pop(qid)
                self._sock.send_multipart([ident, b"", pickle.dumps(out)])

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
            "role": self._role,
            "prefill_backlog_tokens": eng.prefill_backlog_tokens(),
            "segment_transport": self._transport_name,
            **{f"swap_{k}": v for k, v in eng.swap_stats().items()},
            "slo": eng.slo_stats(),
            "slo_digests": eng.slo_digests(),
            "cancelled_total": eng.cancelled_total,
            "preempted_total": eng.preempted_total,
            "preempted_by_class": dict(eng.preempted_by_class),
            # on a card, this process's own allocator's gauges
            **(monitor.device_memory_stats()
               if eng.device.type == "cuda" else {}),
        }

    # -- poll ---------------------------------------------------------------

    def _poll(self) -> worker_base.PollResult:
        batch = self._serve_api()
        self._apply_commands(batch)
        n = self.engine.step()
        self._reply_finished()
        self._reply_staged()
        self._export_engine_metrics()
        return worker_base.PollResult(sample_count=n)

    def _exit_hook(self):
        rec = getattr(self, "_staging", None)
        if rec is not None:
            rec["thread"].join()
        eng = getattr(self, "engine", None)
        if eng is not None:
            leaked = eng.close()
            if leaked:
                self.logger.warning("leak audit at exit: %s", leaked)
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
