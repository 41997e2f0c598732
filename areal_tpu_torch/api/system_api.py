"""Experiment and worker configuration dataclasses (port of
``areal_tpu/api/system_api.py``: the worker configs, ``ExperimentConfig``
with its MFC-graph lazy init, and the ``Experiment`` registry).

Differences from the JAX package:

* ``GenServerConfig.mesh_spec`` is ``None`` or a one-device spec, and
  fields whose feature is not ported are refused by the server when set
  away from their default (see
  :class:`areal_tpu_torch.system.generation_server.GenerationServerWorker`).
* ``ModelWorkerConfig.device`` names the worker's device (``None`` =
  ``cuda``; ``"cpu"`` when the caller asks for the CPU).
* ``GatewayConfig`` and ``EvaluatorConfig`` exist so configs keep their
  shape, and :meth:`ExperimentConfig.lazy_init` refuses them (ROADMAP.md
  queue 1, items 16 and 11).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

from areal_tpu_torch.api.config import (
    AgentAbstraction,
    DatasetAbstraction,
    EnvServiceAbstraction,
    ModelAbstraction,
    ModelBackendAbstraction,
    ModelInterfaceAbstraction,
    ModelName,
)
from areal_tpu_torch.api.dfg import MFCDef, build_graph
from areal_tpu_torch.api.model_api import GenerationHyperparameters
from areal_tpu_torch.base.topology import MeshSpec
from areal_tpu_torch.observability.tracing import TraceConfig


@dataclasses.dataclass
class ExperimentSaveEvalControl:
    """Frequency control for save/eval/recover-ckpt
    (reference: realhf/api/cli_args.py:702)."""

    total_train_epochs: int = 1
    save_freq_epochs: Optional[int] = None
    save_freq_steps: Optional[int] = None
    save_freq_secs: Optional[int] = None
    ckpt_freq_epochs: Optional[int] = None
    ckpt_freq_steps: Optional[int] = None
    ckpt_freq_secs: Optional[int] = None
    eval_freq_epochs: Optional[int] = None
    eval_freq_steps: Optional[int] = None
    eval_freq_secs: Optional[int] = None
    benchmark_steps: Optional[int] = None  # early exit for profiling runs


@dataclasses.dataclass
class ModelShard:
    """One model role hosted by a model worker (reference: system_api.py
    ``StandaloneModelShard``)."""

    model_name: ModelName
    model: ModelAbstraction
    backend: ModelBackendAbstraction
    mesh_spec: MeshSpec = dataclasses.field(default_factory=MeshSpec)
    eval_dataset: Optional[DatasetAbstraction] = None


@dataclasses.dataclass
class ModelWorkerConfig:
    worker_name: str
    shards: List[ModelShard] = dataclasses.field(default_factory=list)
    # interfaces per MFC name (the worker instantiates them lazily)
    interfaces: Dict[str, ModelInterfaceAbstraction] = dataclasses.field(
        default_factory=dict
    )
    datasets: List[DatasetAbstraction] = dataclasses.field(
        default_factory=list
    )
    tokenizer_path: Optional[str] = None
    dataset_seed: int = 1
    # which DP shard of the dataset this worker loads (dp_rank, dp_size)
    dataset_shard: Tuple[int, int] = (0, 1)
    use_stream_dataset: bool = False  # async mode: data arrives by push
    stream_group_size: int = 1  # trajectories per prompt (epoch accounting)
    # publish an int8 serving tree (matmul weights quantized to int8 +
    # per-output-channel f32 scales, sibling v{N}-int8 snapshot dir)
    # next to every full-precision weight publish and advertise it in
    # the manifest.  Servers that set serving_weight_dtype="int8"
    # negotiate onto it (half the staged-swap bytes, half the serving
    # weight HBM); everyone else ignores it.  Costs ~50% extra publish
    # IO — turn off for trainers whose fleet never serves quantized.
    publish_quantized_int8: bool = True
    seed: int = 1
    # the device the worker's engines run on: None = ``cuda``, or "cpu"
    # when the caller asks for the CPU
    device: Optional[str] = None
    # flight-recorder knobs (None = ambient process defaults)
    trace: Optional[TraceConfig] = None


@dataclasses.dataclass
class MasterWorkerConfig:
    worker_name: str = "master"
    model_rpcs: List[MFCDef] = dataclasses.field(default_factory=list)
    model_worker_names: List[str] = dataclasses.field(default_factory=list)
    # worker names hosting each model role (requests broadcast to the group)
    model_groups: Dict[str, List[str]] = dataclasses.field(
        default_factory=dict
    )
    exp_ctrl: ExperimentSaveEvalControl = dataclasses.field(
        default_factory=ExperimentSaveEvalControl
    )
    # the MFC whose n_seqs defines one train iteration
    train_rpc_name: str = ""
    seed: int = 1
    trace: Optional[TraceConfig] = None


@dataclasses.dataclass
class RolloutWorkerConfig:
    worker_name: str
    agent: AgentAbstraction = None
    env: EnvServiceAbstraction = None
    gconfig: GenerationHyperparameters = dataclasses.field(
        default_factory=GenerationHyperparameters
    )
    datasets: List[DatasetAbstraction] = dataclasses.field(
        default_factory=list
    )
    tokenizer_path: Optional[str] = None
    dataset_shard: Tuple[int, int] = (0, 1)
    dataset_seed: int = 1
    rollout_request_timeout: float = 600.0
    new_tokens_per_chunk: int = 1 << 30  # interruptible-generation chunking
    # schedule all group siblings' first chunks in ONE manager RPC
    # (affinity co-locates them anyway); falls back per-qid against an
    # old manager that does not know the batched command
    batch_schedule: bool = True
    # SLO/tenant label this worker's traffic carries end-to-end: it
    # lands in LatencyRecord.workload (fleet-merged per-workload
    # percentile rows) and charges the matching admission-plane tenant.
    # Default: the bulk rollout tenant.
    workload: str = "rollout"
    trace: Optional[TraceConfig] = None


@dataclasses.dataclass
class SpecDecodeConfig:
    """Self-speculative decoding on the paged serving path (default OFF).

    Each row drafts its own continuation by n-gram / prompt-lookup over
    its prompt+output history (no draft model — RL math/code traces are
    repetitive enough), and one batched paged-prefill pass verifies up
    to ``max_draft_tokens`` drafts per step.  Output is token-identical
    to plain GREEDY decode (the engine silently disables the feature
    under non-greedy sampling or a dense cache); rows whose
    acceptance-rate EMA falls below ``min_accept_rate`` drop back to
    plain chunked decode, bounding the worst case.  See
    ``engine/spec_decode.py`` and docs/async_pipeline.md."""

    enabled: bool = False
    # drafts proposed per verify step (the verify window is this + 1:
    # the pending token rides along); each step emits 1..this+1 tokens.
    # Keep at 2^n - 1: windows bucket to powers of two, so 8 drafts pad
    # every verify to 16 positions and double its compute for nothing
    max_draft_tokens: int = 7
    # n-gram sizes tried for the history lookup (longest first)
    ngram_max: int = 3
    ngram_min: int = 1
    # acceptance-rate EMA below which a row falls back to plain decode;
    # None = the measured default in engine/dispatch.py (bench.py's
    # spec_decode_ab derives the break-even rate for the hardware)
    min_accept_rate: Optional[float] = None
    ema_decay: float = 0.9
    # verifies before the fallback threshold may fire
    warmup_verifies: int = 4
    # measured cost of one verify pass in plain-decode-step units (the
    # per-step batch vote's c); None = engine/dispatch.py default.  Pin
    # it from bench.py spec_decode_ab's verify_cost_over_decode_step
    verify_cost_over_decode_step: Optional[float] = None


@dataclasses.dataclass
class GenServerConfig:
    worker_name: str
    model: ModelAbstraction = None
    # None = one device; a mesh spec of world size > 1 is refused
    mesh_spec: Optional[Any] = None
    tokenizer_path: Optional[str] = None
    max_concurrent_batch: int = 64
    kv_cache_len: int = 32768
    # tokens generated device-side between host syncs
    chunk_size: int = 64
    temperature: float = 1.0
    # greedy (argmax) decoding server-wide
    greedy: bool = False
    # KV layout: "auto" uses the paged block pool at kv_cache_len >= 2k and
    # the dense per-row cache below it (and for sliding-window models);
    # kv_pool_tokens sizes the pool (None = max_batch * kv_cache_len);
    # prefill_chunk_tokens bounds the per-step admission prefill (chunked
    # prefill)
    cache_mode: str = "auto"
    page_size: int = 1024
    kv_pool_tokens: Optional[int] = None
    # "auto" (model-dtype pool) or "int8" (int8 pool, f32 scales)
    kv_cache_dtype: str = "auto"
    # "auto" (the published dtype) or "int8" (int8 matmul weights with
    # per-output-channel scales, restored from the publisher's int8 tree)
    serving_weight_dtype: str = "auto"
    prefill_chunk_tokens: int = 1024
    # the radix prefix cache over the paged pool
    prefix_cache: bool = True
    prefix_cache_capacity_frac: float = 0.5
    prefix_cache_min_match_tokens: int = 64
    # bytes of host memory for the prefix cache's spill tier (0 = off)
    prefix_cache_host_bytes: int = 0
    # "unified" only: prefill/decode roles are not ported yet
    role: str = "unified"
    handoff_request_timeout: float = 60.0
    # read only by prefill/decode roles
    handoff_streaming: bool = True
    # "host-numpy" only: the KV fabric is not ported yet
    segment_transport: str = "host-numpy"
    prefix_pull_min_tokens: int = 256
    # self-speculative decoding (a SpecDecodeConfig; None = off)
    spec_decode: Optional[Any] = None
    # the request-level SLO plane (observability/latency.py)
    slo_tracking: bool = True
    # decode-pipeline depth: chunks dispatched but not yet harvested
    pipeline_depth: int = 2
    # dispatch-table overrides (None = engine/dispatch.py defaults)
    paged_min_cache_len: Optional[int] = None
    deep_kernel_min_context: Optional[int] = None
    # 0 only: the compile watch is not ported yet
    compile_quiet_after_steps: int = 0
    # staged weight sync: the snapshot restores through at most this many
    # bytes of host buffers straight onto the engine's device; None =
    # one-shot restore
    stage_chunk_bytes: Optional[int] = 256 * 1024 * 1024
    # which local CUDA device hosts the engine (None = the current one)
    device_idx: Optional[int] = None
    # the engine's device: None = ``cuda`` (``cuda:<device_idx>``), or
    # "cpu" when the caller asks for the CPU
    device: Optional[str] = None
    # multi-process serving is not ported yet: num_processes must be 1
    coordinator: str = ""
    num_processes: int = 1
    process_id: int = 0
    trace: Optional[TraceConfig] = None

    @property
    def world_size(self) -> int:
        """Devices of this server's mesh (1 without a mesh spec)."""
        return int(getattr(self.mesh_spec, "world_size", 1))


@dataclasses.dataclass
class GserverManagerConfig:
    worker_name: str = "gserver_manager"
    n_servers: int = 1
    schedule_policy: str = "round_robin"
    # control-plane serve loop: "router" (default) drains a batch of
    # pending requests per tick off a ZMQ ROUTER socket, processes them
    # under one lock pass, and replies out of order — a gateway storm
    # never queues behind rollout traffic, and slow work (weight-update
    # fan-out) runs off the serve thread.  "rep" restores the legacy
    # strict-lockstep REP loop.  Wire format is identical either way:
    # legacy REQ clients speak to both.
    serve_mode: str = "router"
    # max requests drained per ROUTER serve tick (bounds the time one
    # lock pass can hold the scheduling state)
    serve_batch_max: int = 256
    # O(log N) routing: per-chip load/token min-heaps maintained
    # incrementally on the deltas scheduling already applies, plus a
    # precomputed weighted round-robin cycle rebuilt only when pool
    # membership or mesh shapes change.  False = the O(N) scans
    # (pick-for-pick identical; kept for A/B and paranoia).
    routing_index: bool = True
    max_head_offpolicyness: int = 0
    train_batch_size: int = 1  # in sequences (train_bs_n_seqs)
    group_size: int = 1  # sequences per rollout (staleness unit conversion)
    max_concurrent_rollouts: Optional[int] = None
    flush_request_timeout: float = 120.0
    # cache-aware routing: a session's turns follow the server whose
    # prefix cache is hottest for it (longest prefix served so far),
    # UNLESS that server's estimated resident tokens exceed the least-
    # loaded server's by more than imbalance_factor x + slack — then the
    # affinity breaks (the new server re-prefills; latency beats a hot
    # cache on an overloaded box).  False = the pre-cache behavior
    # (unconditional group affinity + the configured schedule_policy).
    cache_aware_routing: bool = True
    affinity_imbalance_factor: float = 1.5
    affinity_imbalance_slack_tokens: float = 4096.0
    # per-server update_weights retries before the round is declared
    # failed (one flaky server must not block the fleet's version bump)
    update_weights_retries: int = 3
    update_weights_retry_backoff_s: float = 0.5
    # zero-downtime weight sync (default on for published sharded
    # snapshots): servers restore the new snapshot into a device-resident
    # STAGING tree while decode continues (update_weights mode="stage",
    # issued to the whole fleet concurrently), then the fleet pauses only
    # for the pointer-flip commit — pause becomes max(commit) instead of
    # sum(load + transfer + apply).  A server whose stage fails falls
    # back to the legacy full reload inside the pause window, so the
    # fleet always converges on one version.  False = legacy full
    # reloads (still fanned out concurrently).
    staged_weight_updates: bool = True
    # per-server timeout for the stage RPC — generous, because staging
    # runs OFF the paused critical path (decode continues throughout)
    stage_request_timeout: float = 600.0
    # load-aware prefill admission (two-stage P/D fleets): prefill
    # servers report their in-flight prefill-token backlog through the
    # metrics RPC (scraped at most every prefill_backlog_refresh_s,
    # with optimistic local increments between scrapes) and a NEW
    # request's prefill stage goes to the least-backlog-per-chip server
    # instead of the load-blind chip-weighted rotation.  When EVERY
    # prefill server's backlog-per-chip exceeds
    # prefill_saturation_tokens_per_chip, the request is SHED: it
    # routes straight to its decode owner and serves unified-style
    # there (prefill + decode on one server) — admission pressure never
    # queues unboundedly on a saturated prefill pool.  0 disables
    # shedding; prefill_load_aware=False restores the load-blind rotation.
    prefill_load_aware: bool = True
    prefill_backlog_refresh_s: float = 0.5
    prefill_saturation_tokens_per_chip: int = 65536
    # fleet KV fabric (cross-server prefix reuse): the manager's
    # per-session hot-prefix map doubles as a fleet prefix DIRECTORY —
    # when a session's request routes to a server other than its
    # longest-prefix owner, the schedule response carries a kv_source
    # hint and the routed engine peer-pulls the cached prefix instead
    # of re-prefilling it.  Directory entries are stamped with the
    # owner's (model version, cache flush epoch) and invalidated on
    # weight updates, server cache flushes (reported through the
    # existing metrics scrape), and server death — the directory never
    # advertises dropped prefixes.  Hints only pair servers whose
    # segment transports match.  False = hot-prefix tracking behaves
    # exactly as before (affinity only, no hints).
    kv_fabric: bool = True
    # minimum advertised prefix length (tokens) worth a pull hint — the
    # fleet-side floor mirroring the engine's prefix_pull_min_tokens
    kv_fabric_min_prefix_tokens: int = 256
    # per-tenant admission policies (gateway/admission.TenantPolicy rows
    # or plain dicts of their fields): priority class, token-bucket rate
    # limit, cumulative token budget.  Unknown tenants run under the
    # permissive interactive default; rollout traffic charges the
    # "rollout" tenant.  Empty = admit everything.
    tenants: List = dataclasses.field(default_factory=list)
    trace: Optional[TraceConfig] = None


@dataclasses.dataclass
class GatewayConfig:
    """The OpenAI-style HTTP/SSE serving gateway (gateway/server.py):
    one front-door worker per fleet, scheduling through the gserver
    manager and streaming tokens off the gen servers' harvest
    streams."""

    worker_name: str = "gateway"
    host: str = "0.0.0.0"
    port: int = 8081
    # tenant attributed to requests carrying neither an x-tenant header
    # nor a body ``user`` field
    default_tenant: str = "anonymous"
    # byte-codec vocab for string prompts (see gateway/sse.py); set to
    # the serving model's vocab size
    vocab_size: int = 256
    # real tokenizer for string prompts/completions: a HF tokenizer path
    # loaded via dataset_api.load_hf_tokenizer.  Empty = the byte-level
    # codec (token-id prompts are native either way).
    tokenizer_path: str = ""
    max_new_tokens_cap: int = 1024
    request_timeout_s: float = 600.0
    poll_interval_s: float = 0.002
    # manager RPC timeout for the gateway's admission/schedule calls
    manager_timeout_s: float = 60.0
    trace: Optional[TraceConfig] = None


@dataclasses.dataclass
class EvaluatorConfig:
    """Automatic-evaluator knobs (reference: cli_args AutomaticEvaluator —
    ours points the watcher at the saved-checkpoint tree and an eval
    dataset instead of a slurm image)."""

    dataset_path: str
    model_name: str = "actor"
    max_prompts: int = 64
    max_new_tokens: int = 256
    interval: float = 5.0
    # the eval subprocess's device (scheduler/evaluator.py
    # resolve_eval_env): "auto" (default) runs it on a card, a spare one
    # when the workers leave one, else shared with them, pinned with
    # CUDA_VISIBLE_DEVICES (no card is an error); "cpu" runs it on the
    # CPU; "" inherits the environment; a torch device string is passed
    # to the eval CLI as it is
    device: str = "auto"


@dataclasses.dataclass
class ExperimentConfig:
    experiment_name: str
    trial_name: str
    master: MasterWorkerConfig
    model_workers: List[ModelWorkerConfig] = dataclasses.field(
        default_factory=list
    )
    rollout_workers: List[RolloutWorkerConfig] = dataclasses.field(
        default_factory=list
    )
    gen_servers: List[GenServerConfig] = dataclasses.field(
        default_factory=list
    )
    gserver_manager: Optional[GserverManagerConfig] = None
    gateway: Optional[GatewayConfig] = None
    evaluator: Optional[EvaluatorConfig] = None
    # experiment-wide flight-recorder config, propagated to every worker
    # that does not set its own (None = leave workers on ambient defaults)
    trace: Optional[TraceConfig] = None

    def lazy_init(self):
        """Build the MFC graph and sanity-check worker wiring
        (reference: system_api.py ExperimentConfig.lazy_init :190)."""
        build_graph(self.master.model_rpcs)
        if self.gateway is not None:
            raise NotImplementedError(
                "the serving gateway (gateway) is not ported to "
                "areal_tpu_torch yet (ROADMAP.md queue 1, item 16)"
            )
        if self.trace is not None:
            workers = [self.master, self.gserver_manager, self.gateway]
            workers += self.model_workers + self.rollout_workers
            workers += self.gen_servers
            for w in workers:
                if w is not None and w.trace is None:
                    w.trace = self.trace
        if self.gateway is not None and self.gserver_manager is None:
            raise ValueError(
                "gateway worker requires a gserver_manager (it schedules "
                "and admits through the manager's control plane)"
            )
        self.master.model_worker_names = [
            w.worker_name for w in self.model_workers
        ]
        if not self.master.model_groups:
            groups: Dict[str, List[str]] = {}
            for w in self.model_workers:
                for s in w.shards:
                    groups.setdefault(str(s.model_name), []).append(
                        w.worker_name
                    )
            self.master.model_groups = groups
        for rpc in self.master.model_rpcs:
            if str(rpc.model_name) not in self.master.model_groups:
                raise ValueError(
                    f"MFC {rpc.name}: no worker hosts {rpc.model_name}"
                )
        if not self.master.train_rpc_name:
            from areal_tpu_torch.api.dfg import ModelInterfaceType

            trains = [
                r
                for r in self.master.model_rpcs
                if r.interface_type == ModelInterfaceType.TRAIN_STEP
            ]
            if trains:
                self.master.train_rpc_name = trains[0].name
        return self


# ---------------------------------------------------------------------------
# Experiment registry (reference :457-488)
# ---------------------------------------------------------------------------


class Experiment:
    """User-facing experiment: produces an ExperimentConfig."""

    def initial_setup(self) -> ExperimentConfig:
        raise NotImplementedError()


_EXPERIMENTS: Dict[str, Callable[[], Experiment]] = {}


def register_experiment(name: str, cls: Callable[[], Experiment]):
    if name in _EXPERIMENTS:
        raise KeyError(f"experiment {name} already registered")
    _EXPERIMENTS[name] = cls


def make_experiment(name: str, *args, **kwargs) -> Experiment:
    return _EXPERIMENTS[name](*args, **kwargs)


def experiment_cls(name: str) -> Callable[[], Experiment]:
    if name not in _EXPERIMENTS:
        raise KeyError(
            f"unknown experiment {name!r}; registered: {sorted(_EXPERIMENTS)}"
        )
    return _EXPERIMENTS[name]


def list_experiments() -> List[str]:
    return sorted(_EXPERIMENTS)
