"""Canonical metric AND trace name tables (port of
``areal_tpu/observability/table.py``: every name, type and label set is
the JAX package's, so dashboards read both packages; the help text of the
compile watch's entries names the port's mechanism, a kernel library's
build or load, in place of XLA's).

Single source of truth for every Prometheus series the system emits and
every flight-recorder span/event name it records.  The registry resolves
HELP text from here, and a lint (``tests/test_torch_metric_names_lint.py`` for this package) asserts
that every name emitted anywhere in the package appears in its table with
its labels — so a typo'd or renamed metric/span fails CI instead of
silently forking a series.

The tables are *lists* (not dicts) precisely so an accidental duplicate
entry is representable and the lint can catch it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    name: str
    type: str  # "counter" | "gauge" | "histogram"
    help: str
    labels: Tuple[str, ...] = ()


METRIC_TABLE = [
    # -- worker substrate (system/worker_base.py) ---------------------------
    MetricSpec(
        "areal_worker_info",
        "gauge",
        "Constant 1 per live worker; labels identify it",
        ("worker", "group"),
    ),
    MetricSpec(
        "areal_worker_uptime_seconds",
        "gauge",
        "Seconds since the worker's server started",
    ),
    # -- inference engine (engine/inference_server.py) ----------------------
    MetricSpec(
        "areal_inference_chunks_total",
        "counter",
        "Decode chunks harvested by the continuous-batching engine",
    ),
    MetricSpec(
        "areal_inference_host_seconds_total",
        "counter",
        "Engine-loop time spent on host bookkeeping (admit/schedule/park)",
    ),
    MetricSpec(
        "areal_inference_device_seconds_total",
        "counter",
        "Engine-loop time blocked waiting for device compute to finish",
    ),
    MetricSpec(
        "areal_inference_fetch_seconds_total",
        "counter",
        "Engine-loop time fetching chunk outputs to host (tunnel/PCIe)",
    ),
    MetricSpec(
        "areal_inference_generated_tokens_total",
        "counter",
        "New tokens emitted by the engine",
    ),
    MetricSpec(
        "areal_inference_prefill_tokens_total",
        "counter",
        "Unique-prompt tokens actually prefilled (post group-dedup)",
    ),
    MetricSpec(
        "areal_inference_async_fetches_total",
        "counter",
        "Decode chunks whose outputs started an async device-to-host "
        "copy at dispatch time (the fetch-overlap half of the pipeline)",
    ),
    MetricSpec(
        "areal_inference_fetch_ready_total",
        "counter",
        "Harvests that found the oldest in-flight chunk already complete "
        "(its output fetch fully overlapped by newer chunks' device time)",
    ),
    MetricSpec(
        "areal_inference_prefix_cache_hits_total",
        "counter",
        "Admissions whose prompt matched a cached prefix in the "
        "cross-request radix cache (suffix-only prefill)",
    ),
    MetricSpec(
        "areal_inference_prefix_cache_misses_total",
        "counter",
        "Admissions that found no usable cached prefix",
    ),
    MetricSpec(
        "areal_inference_prefix_cached_tokens_total",
        "counter",
        "Prompt tokens served from the radix prefix cache instead of "
        "being re-prefilled",
    ),
    MetricSpec(
        "areal_inference_prefix_cache_evictions_total",
        "counter",
        "Radix-cache entries dropped (LRU capacity trims + pool-pressure "
        "reclamation yielding blocks to live rows)",
    ),
    MetricSpec(
        "areal_inference_prefix_cache_blocks",
        "gauge",
        "Pool blocks currently referenced by the radix prefix cache",
    ),
    MetricSpec(
        "areal_inference_prefix_host_spilled_blocks_total",
        "counter",
        "Radix-cache blocks spilled from HBM into the host tier instead "
        "of dying on eviction (batched device-to-host gather per "
        "reclamation round)",
    ),
    MetricSpec(
        "areal_inference_prefix_host_restored_blocks_total",
        "counter",
        "Host-tier blocks swapped back into freshly allocated pool "
        "blocks after a prefix match landed on a spilled entry (async "
        "dispatch riding the decode ring's overlap)",
    ),
    MetricSpec(
        "areal_inference_prefix_host_dropped_blocks_total",
        "counter",
        "Host-tier entries dropped outright (byte-budget LRU trims, "
        "orphaned spilled subtrees, weight-swap flushes)",
    ),
    MetricSpec(
        "areal_inference_prefix_host_bytes",
        "gauge",
        "Host memory currently held by spilled prefix-cache blocks "
        "(bounded by prefix_cache_host_bytes)",
    ),
    MetricSpec(
        "areal_inference_prefix_host_blocks",
        "gauge",
        "Prefix-cache blocks currently resident in the host tier",
    ),
    MetricSpec(
        "areal_inference_spec_draft_tokens_total",
        "counter",
        "Draft tokens proposed by self-speculative n-gram drafting "
        "(per verify window, before verification)",
    ),
    MetricSpec(
        "areal_inference_spec_accepted_tokens_total",
        "counter",
        "Draft tokens confirmed by the batched paged verify pass "
        "(each saves one full decode step)",
    ),
    MetricSpec(
        "areal_inference_spec_rejected_tokens_total",
        "counter",
        "Draft tokens the verify pass diverged from (truncated at the "
        "first mismatch; the verifier's own token is emitted instead)",
    ),
    MetricSpec(
        "areal_inference_spec_verify_chunks_total",
        "counter",
        "Speculative verify windows dispatched (each is one batched "
        "paged prefill over the participating rows' drafts)",
    ),
    MetricSpec(
        "areal_inference_spec_fallback_rows_total",
        "counter",
        "Rows whose acceptance-rate EMA fell below the spec-decode "
        "threshold and dropped back to plain chunked decode",
    ),
    MetricSpec(
        "areal_inference_spec_accept_rate",
        "histogram",
        "Per-verify-window acceptance fraction (accepted / drafted) — "
        "the live readout of whether self-drafting pays on this "
        "workload",
    ),
    MetricSpec(
        "areal_inference_kv_quant_storage_bits",
        "gauge",
        "Bits per stored KV element in the serving cache (8 = int8 "
        "quantized pools with per-(block, head, slot) scales; 16/32 = "
        "model-dtype storage, kv_cache_dtype='auto')",
    ),
    MetricSpec(
        "areal_inference_kv_quant_blocks",
        "gauge",
        "Pool blocks currently held in quantized (int8) storage — live "
        "rows, prefix-cache references, and in-flight fills together; 0 "
        "on an unquantized engine",
    ),
    MetricSpec(
        "areal_inference_kv_quant_divergence_checks_total",
        "counter",
        "Greedy-divergence checks folded into the engine by quality "
        "harnesses (bench kv_quant_ab / parity tests comparing the int8 "
        "arm against an fp arm token by token)",
    ),
    MetricSpec(
        "areal_inference_kv_quant_divergence_diverged_total",
        "counter",
        "Checked requests whose int8-arm greedy stream diverged from "
        "the fp arm's (the measured token-quality delta the quantized "
        "serving rollout is gated on)",
    ),
    MetricSpec(
        "areal_inference_weight_quant_storage_bits",
        "gauge",
        "Bits per stored element of the serving param tree's matmul "
        "weights (8 = int8 + per-output-channel scales, "
        "serving_weight_dtype='int8'; 16/32 = model-dtype storage)",
    ),
    MetricSpec(
        "areal_inference_weight_quant_leaves",
        "gauge",
        "Projection leaves of the RESIDENT serving tree held in "
        "quantized {int8 weight, f32 scale} form — 0 on a "
        "full-precision engine",
    ),
    MetricSpec(
        "areal_inference_weight_quant_divergence_checks_total",
        "counter",
        "Greedy-divergence checks folded into the engine by quality "
        "harnesses (bench weight_quant_ab / parity tests comparing the "
        "int8-weight arm against a full-precision arm token by token)",
    ),
    MetricSpec(
        "areal_inference_weight_quant_divergence_diverged_total",
        "counter",
        "Checked requests whose int8-weight greedy stream diverged "
        "from the full-precision arm's (the measured token-quality "
        "delta the quantized-weight serving rollout is gated on)",
    ),
    MetricSpec(
        "areal_inference_handoff_exports_total",
        "counter",
        "Paged-block KV handoff units exported by a prefill-role server "
        "(one per request handed to a decode peer)",
    ),
    MetricSpec(
        "areal_inference_handoff_imports_total",
        "counter",
        "Handoff units imported and parked by a decode-role server "
        "(the continuation resumes over them with zero prefill)",
    ),
    MetricSpec(
        "areal_inference_handoff_import_rejects_total",
        "counter",
        "Handoff imports rejected fail-closed, by reason (version = "
        "weight-swap skew; layout | dense | capacity | pool | empty | "
        "scatter; streamed handoffs add stream = sequence gap/unknown "
        "stream, abort = exporter cut the stream short, expired = the "
        "dead-peer TTL released a half-received stream); the "
        "continuation re-prefills on the decode server",
        ("reason",),
    ),
    MetricSpec(
        "areal_inference_handoff_segment_exports_total",
        "counter",
        "Streamed-handoff segments exported by a prefill-role server "
        "(one per fill-chunk boundary of a handoff-flagged row, plus "
        "the final tail+metadata segment)",
    ),
    MetricSpec(
        "areal_inference_handoff_segment_imports_total",
        "counter",
        "Streamed-handoff segments imported and scattered by a "
        "decode-role server (the scatters ride under its decode chunks "
        "while the prefill side is still filling)",
    ),
    MetricSpec(
        "areal_inference_handoff_segment_aborts_total",
        "counter",
        "Export streams cut short by the prefill server (EOS at the "
        "first token, a weight swap restarting the fill) — the decode "
        "peer releases its partial blocks",
    ),
    MetricSpec(
        "areal_inference_handoff_bytes_total",
        "counter",
        "Host bytes moved by KV handoffs (export gathers + import "
        "scatters; int8 pools move quantized bytes + scales)",
    ),
    MetricSpec(
        "areal_inference_handoff_seconds_total",
        "counter",
        "Time spent in KV-handoff device<->host block copies (export "
        "gather on the prefill side + import scatter dispatch on the "
        "decode side)",
    ),
    MetricSpec(
        "areal_inference_prefix_peer_pulls_total",
        "counter",
        "Fleet KV-fabric prefix pulls COMPLETED by this engine (a peer's "
        "cached prefix imported segment by segment and radix-inserted; "
        "the admission's re-prefill shrank to the un-pulled suffix)",
    ),
    MetricSpec(
        "areal_inference_prefix_peer_pull_bytes_total",
        "counter",
        "Host bytes imported by completed fleet prefix pulls (int8 "
        "pools move quantized bytes + scales)",
    ),
    MetricSpec(
        "areal_inference_prefix_peer_pull_rejects_total",
        "counter",
        "Fleet prefix pulls failed closed, by reason (version = weight-"
        "swap skew mid-pull; layout | dense | pool | scatter | stream "
        "mirror the handoff-segment rules; miss = the owner no longer "
        "held the prefix; rpc = the export call to the owner died; "
        "spmd = a multi-controller owner refused the export; expired = "
        "the dead-owner TTL) — the admission re-prefills plainly",
        ("reason",),
    ),
    MetricSpec(
        "areal_inference_inflight_rows",
        "gauge",
        "Rows currently decoding or chunk-filling",
    ),
    MetricSpec(
        "areal_inference_ring_depth",
        "gauge",
        "Configured decode-pipeline depth (max in-flight decode chunks)",
    ),
    MetricSpec(
        "areal_inference_inflight_chunks",
        "gauge",
        "Decode chunks currently dispatched but not yet harvested "
        "(pipeline-ring occupancy; bounded by areal_inference_ring_depth)",
    ),
    MetricSpec(
        "areal_inference_pending_requests",
        "gauge",
        "Requests queued for admission",
    ),
    MetricSpec(
        "areal_inference_mesh_devices",
        "gauge",
        "Chips this engine's sharded forward spans (one server = one "
        "mesh; 1 for a single-chip engine)",
    ),
    MetricSpec(
        "areal_inference_weight_version",
        "gauge",
        "Weight version the engine currently serves",
    ),
    MetricSpec(
        "areal_inference_swap_stage_seconds_total",
        "counter",
        "Time spent restoring/transferring staged weight trees while "
        "decode continued (the off-critical-path half of a staged swap)",
    ),
    MetricSpec(
        "areal_inference_swap_pause_seconds_total",
        "counter",
        "Time weight swaps actually interrupted decode (ring drain + "
        "pointer flip or full reload + prefix flush + in-flight "
        "recompute)",
    ),
    MetricSpec(
        "areal_inference_weight_swaps_total",
        "counter",
        "Weight swaps applied by the engine (staged pointer-flips + "
        "legacy full reloads)",
    ),
    MetricSpec(
        "areal_inference_weight_swaps_staged_total",
        "counter",
        "Weight swaps applied as staged pointer-flips (pre-restored, "
        "zero transfer inside the pause)",
    ),
    # -- request-level SLO plane (observability/latency.py consumers) --------
    # Each family is a histogram over the FIXED log-bucket boundaries
    # latency.SLO_BUCKETS, so the master can rebuild + exactly merge
    # per-worker digests into fleet percentiles (the lint asserts this
    # vocabulary matches latency.SLO_FAMILIES both ways).
    MetricSpec(
        "areal_slo_schedule_wait_seconds",
        "histogram",
        "Time a rollout waited at the gserver manager's admission gate "
        "(first rejected allocate to the eventual ok; 0 when admitted "
        "immediately) — SLO digest, fixed log buckets",
        ("workload",),
    ),
    MetricSpec(
        "areal_slo_admission_wait_seconds",
        "histogram",
        "Time a request queued at the engine between submit and cache-"
        "row admission — SLO digest, fixed log buckets",
        ("workload",),
    ),
    MetricSpec(
        "areal_slo_ttft_seconds",
        "histogram",
        "Time to first token: engine submit to the first generated "
        "token (queue + prefill) — SLO digest, fixed log buckets",
        ("workload",),
    ),
    MetricSpec(
        "areal_slo_tpot_seconds",
        "histogram",
        "Per-token time: mean inter-token gap after the first token, "
        "one observation per finished request — SLO digest, fixed log "
        "buckets",
        ("workload",),
    ),
    MetricSpec(
        "areal_slo_stall_seconds",
        "histogram",
        "Time a request spent quiesced by weight swaps or parked by "
        "preemption while in flight — SLO digest, fixed log buckets",
        ("workload",),
    ),
    # -- gserver manager (system/gserver_manager.py) -------------------------
    MetricSpec(
        "areal_gserver_alloc_rejections_total",
        "counter",
        "Rollout allocations rejected, by reason (staled | capacity)",
        ("reason",),
    ),
    MetricSpec(
        "areal_gserver_running_rollouts",
        "gauge",
        "Rollouts currently in flight (queue depth of the staleness gate)",
    ),
    MetricSpec(
        "areal_gserver_accepted_rollouts_total",
        "counter",
        "Rollouts finished and accepted",
    ),
    MetricSpec(
        "areal_gserver_model_version",
        "gauge",
        "Latest weight version pushed to the generation servers",
    ),
    MetricSpec(
        "areal_gserver_version_lag",
        "gauge",
        "expected_version - model_version (staleness headroom consumed)",
    ),
    MetricSpec(
        "areal_gserver_server_requests",
        "gauge",
        "Sticky requests resident per generation server",
        ("server",),
    ),
    MetricSpec(
        "areal_gserver_server_tokens",
        "gauge",
        "Estimated resident tokens per generation server",
        ("server",),
    ),
    MetricSpec(
        "areal_gserver_server_mesh_devices",
        "gauge",
        "Chips behind each generation server's mesh (registration-"
        "derived; routing and capacity weights scale with it)",
        ("server",),
    ),
    MetricSpec(
        "areal_gserver_affinity_escapes_total",
        "counter",
        "Sessions re-routed away from their prefix-hot server because "
        "the load-imbalance escape hatch fired",
    ),
    MetricSpec(
        "areal_gserver_pd_role_servers",
        "gauge",
        "Registered generation servers per serving role (prefill | "
        "decode | unified); two-stage P/D routing is active iff both "
        "prefill and decode are nonzero",
        ("role",),
    ),
    MetricSpec(
        "areal_gserver_pd_handoff_routes_total",
        "counter",
        "New requests routed through the two-stage prefill->handoff->"
        "decode path (continuations sticky-route and are not counted)",
    ),
    MetricSpec(
        "areal_gserver_prefill_backlog_tokens",
        "gauge",
        "Estimated in-flight prefill-token backlog per prefill server "
        "(metrics-RPC scrape + optimistic local increments) — the load "
        "signal least-backlog prefill admission routes on",
        ("server",),
    ),
    MetricSpec(
        "areal_gserver_prefill_sheds_total",
        "counter",
        "New requests shed to unified-style serving on their decode "
        "owner because every prefill server's backlog-per-chip "
        "exceeded prefill_saturation_tokens_per_chip",
    ),
    MetricSpec(
        "areal_gserver_kv_fabric_directory_entries",
        "gauge",
        "Live entries in the manager's fleet prefix directory (version-"
        "and-flush-epoch-stamped hot-prefix records a kv_source pull "
        "hint may cite)",
    ),
    MetricSpec(
        "areal_gserver_kv_fabric_pull_routes_total",
        "counter",
        "Schedule responses that carried a kv_source hint (the routed "
        "engine peer-pulls the named owner's cached prefix instead of "
        "re-prefilling it)",
    ),
    MetricSpec(
        "areal_gserver_kv_fabric_invalidations_total",
        "counter",
        "Fleet prefix-directory entries dropped, by reason "
        "(weight_update = fleet-wide flush on a version bump; flush = "
        "the owner's scraped prefix_cache_flushes_total moved; death = "
        "consecutive failed epoch scrapes declared the owner dead)",
        ("reason",),
    ),
    MetricSpec(
        "areal_gserver_weight_update_pause_seconds",
        "gauge",
        "Fleet pause of the most recent weight update (pause RPCs to "
        "resume RPCs) — staged rounds pay max(commit), legacy rounds "
        "pay the full reload",
    ),
    MetricSpec(
        "areal_gserver_weight_updates_total",
        "counter",
        "Fleet weight-update rounds attempted, by protocol "
        "(staged | full)",
        ("mode",),
    ),
    MetricSpec(
        "areal_gserver_control_serve_batch_size",
        "histogram",
        "Requests drained per ROUTER serve tick (batch size; the "
        "strict-lockstep rep mode never batches, so this family only "
        "moves under serve_mode=router)",
    ),
    MetricSpec(
        "areal_gserver_control_queue_depth",
        "gauge",
        "Control-plane requests pending at the start of the most "
        "recent serve tick (drained backlog on the ROUTER socket)",
    ),
    MetricSpec(
        "areal_gserver_control_requests_total",
        "counter",
        "Control-plane commands handled, by command name "
        "(schedule_request | schedule_batch | gateway_submit | ...)",
        ("cmd",),
    ),
    MetricSpec(
        "areal_gserver_control_handler_seconds_total",
        "counter",
        "Cumulative seconds spent inside control-plane command "
        "handlers, by command name — divide by requests_total for "
        "mean handler latency",
        ("cmd",),
    ),
    # -- serving gateway (gateway/server.py + admission plane) ---------------
    MetricSpec(
        "areal_gateway_requests_total",
        "counter",
        "HTTP requests received at the gateway front door "
        "(/v1/completions + /v1/chat/completions, streaming or not)",
    ),
    MetricSpec(
        "areal_gateway_streams_total",
        "counter",
        "SSE streaming responses started at the gateway",
    ),
    MetricSpec(
        "areal_gateway_active_streams",
        "gauge",
        "SSE streams currently open at the gateway",
    ),
    MetricSpec(
        "areal_gateway_admission_rejects_total",
        "counter",
        "Tenant admission-plane rejects, by typed reason "
        "(rate_limited | budget_exhausted | request_too_large) — "
        "incremented at the gateway front door (HTTP 429/403) and at "
        "the gserver manager's gateway_admit command",
        ("reason",),
    ),
    MetricSpec(
        "areal_gateway_preemptions_total",
        "counter",
        "Pool-pressure row preemptions by the victim's priority class "
        "(interactive | bulk) — priority-aware eviction picks bulk "
        "rollout rows before interactive gateway rows",
        ("class",),
    ),
    # -- master buffer (system/buffer.py) ------------------------------------
    MetricSpec(
        "areal_buffer_size",
        "gauge",
        "Sequences resident in the master's sequence buffer",
    ),
    MetricSpec(
        "areal_buffer_oldest_sample_age_seconds",
        "gauge",
        "Age of the oldest buffered sequence (birth-time to now)",
    ),
    # -- train engine (engine/train_engine.py) -------------------------------
    MetricSpec(
        "areal_train_step_seconds",
        "histogram",
        "Wall time of one train_batch call (pad + dispatch + host sync)",
        ("model",),
    ),
    MetricSpec(
        "areal_train_tokens_total",
        "counter",
        "Real (non-padding) tokens consumed by train steps",
        ("model",),
    ),
    MetricSpec(
        "areal_train_tokens_per_second",
        "gauge",
        "Token throughput of the most recent train step",
        ("model",),
    ),
    MetricSpec(
        "areal_train_mfu",
        "gauge",
        "Model FLOPs utilization of the most recent train step (0-1)",
        ("model",),
    ),
    MetricSpec(
        "areal_train_padding_frac",
        "gauge",
        "Fraction of the most recent train step's stacked [n, B, T] "
        "device slots that held padding (incl. all-zero bucketing "
        "micro-batches) — the waste sequence packing exists to shrink",
        ("model",),
    ),
    MetricSpec(
        "areal_train_version",
        "gauge",
        "Optimizer-step count of this engine (published weight version)",
        ("model",),
    ),
    # -- rollout worker (system/rollout_worker.py) ---------------------------
    MetricSpec(
        "areal_rollout_episodes_total",
        "counter",
        "Rollout episodes finished (accepted or not)",
    ),
    MetricSpec(
        "areal_rollout_pushed_total",
        "counter",
        "Trajectories pushed to the training stream",
    ),
    MetricSpec(
        "areal_rollout_alloc_rejected_total",
        "counter",
        "allocate_rollout denials observed, by reason",
        ("reason",),
    ),
    # -- host/device monitor (base/monitor.py) -------------------------------
    MetricSpec("areal_host_load1", "gauge", "Host 1-minute load average"),
    MetricSpec("areal_host_load5", "gauge", "Host 5-minute load average"),
    MetricSpec("areal_host_rss_gb", "gauge", "Worker process RSS in GB"),
    MetricSpec(
        "areal_device_hbm_in_use_gb",
        "gauge",
        "HBM bytes in use per local device, in GB",
        ("device",),
    ),
    MetricSpec(
        "areal_device_hbm_peak_gb",
        "gauge",
        "Peak HBM bytes in use per local device, in GB",
        ("device",),
    ),
    MetricSpec(
        "areal_device_hbm_limit_gb",
        "gauge",
        "HBM capacity per local device, in GB",
        ("device",),
    ),
    MetricSpec(
        "areal_time_mark_seconds",
        "histogram",
        "Named wall-clock intervals recorded via monitor.time_mark",
        ("mark",),
    ),
    # -- HBM ledger (observability/hbm_ledger.py) ----------------------------
    MetricSpec(
        "areal_hbm_ledger_bytes",
        "gauge",
        "Bytes currently attributed to each subsystem by the device-"
        "memory ledger (see hbm_ledger.SUBSYSTEMS for the tag taxonomy; "
        "host-side tags carry host bytes)",
        ("subsystem",),
    ),
    MetricSpec(
        "areal_hbm_ledger_peak_bytes",
        "gauge",
        "High-watermark bytes each ledger subsystem ever held (resets "
        "with the process; the capacity-planning ceiling)",
        ("subsystem",),
    ),
    MetricSpec(
        "areal_hbm_ledger_drift_gb",
        "gauge",
        "Excess of the ledger's device-tag sum over the device's "
        "reported HBM in-use bytes, in GB (0 while sum(ledger) <= "
        "in_use + tolerance; nonzero = the ledger double-counts or a "
        "release was missed)",
    ),
    # -- recompile sentinel (observability/compile_watch.py) -----------------
    MetricSpec(
        "areal_xla_compiles_total",
        "counter",
        "Kernel-library loads observed per watched entry point (growth "
        "of the libraries it launches that are loaded) plus the "
        "process-wide library builds and loads under fn=backend",
        ("fn",),
    ),
    MetricSpec(
        "areal_xla_compile_seconds",
        "histogram",
        "nvcc seconds of each kernel-library build (0 for a library "
        "found built on disk; process-wide, per-fn attribution rides "
        "areal_xla_compiles_total)",
    ),
    # -- master / stats fan-in (system/master_worker.py) ---------------------
    MetricSpec(
        "areal_master_step_seconds",
        "histogram",
        "End-to-end wall time of one master step (full MFC graph)",
    ),
    MetricSpec(
        "areal_stats",
        "gauge",
        "Scalar stats exported from the hierarchical stats tracker",
        ("key",),
    ),
    # -- aggregator self-metrics (observability/aggregator.py) ---------------
    MetricSpec(
        "areal_aggregator_scrape_errors_total",
        "counter",
        "Failed /metrics scrapes, by endpoint key",
        ("endpoint",),
    ),
    # -- flight recorder (observability/tracing.py + trace_collector.py) -----
    MetricSpec(
        "areal_trace_stall_total",
        "counter",
        "Stall-watchdog flags, by kind (the STALL_KINDS vocabulary "
        "below); each stalled span / breach episode counts once",
        ("kind",),
    ),
    MetricSpec(
        "areal_trace_harvest_errors_total",
        "counter",
        "Failed /trace harvests, by endpoint key (skip-and-count: a dead "
        "or garbage endpoint never fails a master step)",
        ("endpoint",),
    ),
    MetricSpec(
        "areal_trace_events_total",
        "counter",
        "Flight-recorder events harvested into traces.jsonl",
    ),
    MetricSpec(
        "areal_train_sample_staleness",
        "histogram",
        "Per-trained-sample weight-version lag: current version minus "
        "the version the sample finished generating under",
        ("model",),
    ),
    # -- the port's own series (none in the JAX package's table) ------------
    MetricSpec(
        "areal_weight_publish_seconds",
        "histogram",
        "Seconds of one weight publish on the model worker, by part: "
        "full (the host copy of the full tree), int8 (its int8 serving "
        "tree), commit (the background write of both)",
        ("part",),
    ),
]

#: the entries of METRIC_TABLE that only the port emits; every other entry
#: is the JAX package's, in its order
PORT_ONLY_METRICS = ("areal_weight_publish_seconds",)


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """One canonical flight-recorder span/event name.  ``kind`` is
    "span" (recorded via span_begin/span_end/span — a duration) or
    "event" (instant)."""

    name: str
    kind: str  # "span" | "event"
    help: str


TRACE_TABLE = [
    # -- rollout worker / partial rollout ------------------------------------
    TraceSpec(
        "rollout.episode",
        "span",
        "One rollout episode on the rollout worker: allocate -> agent/env "
        "loop -> push -> finish (attrs: accepted, pushed)",
    ),
    TraceSpec(
        "rollout.alloc_reject",
        "event",
        "allocate_rollout denial observed worker-side (attrs: reason)",
    ),
    TraceSpec(
        "rollout.generate",
        "span",
        "One group member's full generation across all chunked "
        "continuations (attrs: chunks, retries, version_start/end)",
    ),
    TraceSpec(
        "rollout.chunk",
        "span",
        "One schedule+generate chunk attempt from the partial-rollout "
        "client (attrs: attempt, gen_qid, server)",
    ),
    TraceSpec(
        "rollout.retry",
        "event",
        "Transient RPC failure during schedule/generate; the trace root "
        "is force-sampled from here on (attrs: stage, attempt, error)",
    ),
    # -- gserver manager -----------------------------------------------------
    TraceSpec(
        "gserver.allocate",
        "event",
        "Staleness/capacity gate decision for a rollout (attrs: ok, "
        "reason, version_lag)",
    ),
    TraceSpec(
        "gserver.schedule",
        "event",
        "Routing decision for a request (attrs: server, sticky, "
        "prompt_len, version)",
    ),
    TraceSpec(
        "gserver.handoff_route",
        "event",
        "New request routed through the two-stage P/D path (attrs: "
        "prefill = the server filling the blocks, decode = the server "
        "owning the request after the handoff)",
    ),
    TraceSpec(
        "gserver.kv_fabric_route",
        "event",
        "Schedule response carried a kv_source pull hint (attrs: "
        "target = the routed server, source = the prefix owner, "
        "prompt_len)",
    ),
    TraceSpec(
        "gserver.finish",
        "event",
        "Rollout slot released at the manager (attrs: accepted)",
    ),
    TraceSpec(
        "gserver.gateway_admit",
        "event",
        "Tenant admission-plane decision for a gateway request "
        "(attrs: tenant, ok, reason)",
    ),
    # -- generation engine ---------------------------------------------------
    TraceSpec(
        "engine.admit",
        "event",
        "Request admitted into a cache row (attrs: row, cached_tokens "
        "from the radix prefix cache, prompt_len)",
    ),
    TraceSpec(
        "engine.resume",
        "event",
        "Parked row resumed for a chunked continuation with zero "
        "prefill (attrs: row)",
    ),
    TraceSpec(
        "engine.fill_chunk",
        "event",
        "One chunked-prefill batch advanced this request's fill "
        "(attrs: tokens, fill_pos)",
    ),
    TraceSpec(
        "engine.chunk",
        "event",
        "One harvested decode chunk's tokens folded into this row "
        "(attrs: row, epoch, n_tokens, step)",
    ),
    TraceSpec(
        "decode.draft",
        "event",
        "Self-speculative n-gram draft proposed for a row "
        "(attrs: row, tokens)",
    ),
    TraceSpec(
        "decode.verify",
        "span",
        "One speculative verify window, dispatch to harvest: a batched "
        "paged prefill of the row's draft (attrs: row, drafted, "
        "accepted, emitted)",
    ),
    TraceSpec(
        "swap.stage",
        "span",
        "Staged weight restore on the generation server: snapshot "
        "restore -> device-resident staging tree, while decode "
        "continues (attrs: version; root swap-v{n}, force-sampled)",
    ),
    TraceSpec(
        "swap.commit",
        "span",
        "The weight-swap apply window that actually interrupts decode: "
        "ring drain -> pointer flip (or legacy full reload) -> prefix "
        "flush -> in-flight recompute (attrs: version, pre_sharded, "
        "interrupted)",
    ),
    TraceSpec(
        "engine.handoff_export",
        "event",
        "Parked prefill row's KV blocks gathered to host and exported "
        "as a handoff unit (attrs: row, blocks, bytes, version)",
    ),
    TraceSpec(
        "engine.handoff_import",
        "event",
        "Handoff unit imported (scattered into fresh pool blocks and "
        "parked for resume) or rejected fail-closed (attrs: ok, reason "
        "on reject, row, blocks, bytes, version; streamed=True when the "
        "final segment of a streamed handoff parked the row)",
    ),
    TraceSpec(
        "engine.handoff_segment",
        "event",
        "One streamed-handoff segment exported at a fill-chunk boundary "
        "(attrs: seq, blocks, bytes, final, version; abort=True with a "
        "reason when the exporter cut the stream short)",
    ),
    TraceSpec(
        "engine.handoff_segment_import",
        "event",
        "One streamed-handoff segment scattered into the decode "
        "server's pre-allocated blocks (attrs: seq, blocks, bytes, "
        "final, version)",
    ),
    TraceSpec(
        "engine.prefix_export",
        "event",
        "Owner side of a fleet prefix pull: the cached run covering the "
        "peer's tokens gathered into wire segments (attrs: blocks, "
        "tokens, segments, version)",
    ),
    TraceSpec(
        "engine.prefix_pull",
        "event",
        "Puller side of a fleet prefix pull: intent registered (attrs: "
        "source, prompt_len, resident), completed (ok=True, blocks, "
        "tokens, bytes), or failed closed (ok=False, reason)",
    ),
    TraceSpec(
        "engine.finish",
        "event",
        "Row finished or parked; the request's result is ready "
        "(attrs: park, n_tokens, version_start, version_end)",
    ),
    TraceSpec(
        "engine.preempt",
        "event",
        "Row preempted under pool pressure (recompute-on-readmit; "
        "attrs: row, cached_tokens)",
    ),
    TraceSpec(
        "engine.cancel",
        "event",
        "Request cancelled (gateway client disconnect or stale-stream "
        "backstop); the row's pool blocks are released (attrs: step)",
    ),
    TraceSpec(
        "engine.recompute",
        "event",
        "In-flight row's KV re-prefilled under freshly swapped weights "
        "(attrs: version)",
    ),
    # -- master buffer / train -----------------------------------------------
    TraceSpec(
        "buffer.resident",
        "span",
        "Sample resident in the master sequence buffer, push to final "
        "consumption (attrs: version = version_end at push)",
    ),
    TraceSpec(
        "buffer.consume",
        "event",
        "Sample handed to an MFC from the buffer (attrs: rpc)",
    ),
    TraceSpec(
        "train.consume",
        "event",
        "Sample consumed by a train step (attrs: step, staleness, model)",
    ),
    # -- recompile sentinel --------------------------------------------------
    TraceSpec(
        "xla.compile",
        "span",
        "One detected kernel-library load of a watched entry point "
        "(attrs: fn, n new libraries, the caller-provided shape/dtype "
        "signature)",
    ),
]


@dataclasses.dataclass(frozen=True)
class StallKindSpec:
    """One canonical stall-watchdog ``kind`` label value (the vocabulary
    of ``areal_trace_stall_total``)."""

    name: str
    help: str


#: every value the ``kind`` label of ``areal_trace_stall_total`` may
#: carry.  ``scripts/check_metric_names.py`` lints this table against
#: every emission site BOTH WAYS (an unlisted literal at an emission
#: site fails, and a listed kind nothing emits is dead vocabulary) —
#: route every new fire through :func:`stall_kind` or a literal
#: ``kind="..."`` keyword so the lint can see it.
STALL_KIND_TABLE = [
    StallKindSpec(
        "span_deadline",
        "An open trace span outlived the per-span wall-clock deadline "
        "(a wedged rollout/request)",
    ),
    StallKindSpec(
        "buffer_age",
        "A buffered sample sat unconsumed across too many weight "
        "versions (train side starving or rollout side flooding)",
    ),
    StallKindSpec(
        "slo",
        "The fleet TTFT p99 breached its objective for N consecutive "
        "scrapes (fires once per breach episode, re-arms on recovery)",
    ),
    StallKindSpec(
        "recompile",
        "A kernel library loaded for a watched decode/fill entry point "
        "after the engine reached steady state (fires once per compile "
        "episode, re-arms after a quiet poll)",
    ),
]

STALL_KINDS = tuple(s.name for s in STALL_KIND_TABLE)


def stall_kind(kind: str) -> str:
    """Validate-and-return a stall ``kind``.  Emission sites that pick a
    kind dynamically wrap each candidate literal in this (identity at
    runtime, plus a membership check), which is exactly the marker the
    stall-kind lint collects."""
    if kind not in STALL_KINDS:
        raise ValueError(
            f"unknown stall kind {kind!r}; add it to "
            "table.STALL_KIND_TABLE (and docs) first"
        )
    return kind


def trace_table_index() -> Dict[str, TraceSpec]:
    out: Dict[str, TraceSpec] = {}
    for spec in TRACE_TABLE:
        if spec.name in out:
            raise ValueError(f"duplicate trace table entry: {spec.name}")
        out[spec.name] = spec
    return out


def table_index() -> Dict[str, MetricSpec]:
    """name -> spec.  Raises if the table itself holds duplicates (the
    lint reports this as a table error rather than crashing)."""
    out: Dict[str, MetricSpec] = {}
    for spec in METRIC_TABLE:
        if spec.name in out:
            raise ValueError(f"duplicate metric table entry: {spec.name}")
        out[spec.name] = spec
    return out
