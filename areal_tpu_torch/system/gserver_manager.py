"""Generation-server manager: routing, staleness gating, weight updates
(copy of ``areal_tpu/system/gserver_manager.py``, with two changes: the
staleness gate's sample count is repaired, see
:meth:`GserverManager.version_lag`; and the serve loop waits on its socket
when idle instead of spinning, since the port's decode loop runs Python
on the host and a spinning thread of the same process takes Python's lock
from it).

Rebuild of the reference's gserver manager (reference:
realhf/system/gserver_manager.py :32 — FastAPI ``/schedule_request``
(sticky-by-qid, round_robin / least_requests) :371-409,
``/allocate_rollout`` (max_concurrent_rollouts + ``is_staled()``:
expected_version = (trained_samples + running) / train_bs vs
version + max_head_offpolicyness) :417-453, ``/finish_rollout`` :455,
weight-update trigger on name_resolve model_version :158-190).

The service is a ZMQ REP socket (the control plane's HTTP equivalent):
  ("schedule_request", {qid})            -> {"url": addr, "version": v}
  ("allocate_rollout", {qid})            -> {"ok": bool, "reason": str}
  ("finish_rollout", {qid, accepted})    -> "ok"
  ("get_status", {})                     -> counters
  ("gateway_admit", {tenant, tokens})    -> AdmissionDecision dict
  ("gateway_finish", {qid, tenant, reserved_tokens, used_tokens}) -> "ok"
  ("gateway_reset_budget", {tenant})     -> "ok"

The gateway commands expose the per-tenant admission plane
(``gateway/admission.py``): priority classes, token-bucket rate limits,
and cumulative token budgets, enforced here at allocate/schedule time.
Rollout traffic rides the SAME plane under a default bulk tenant (the
``allocate_rollout`` gate), so training and serving genuinely share
one accounting surface.
"""

from __future__ import annotations

import heapq
import pickle
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import zmq

from areal_tpu_torch.api import system_api
from areal_tpu_torch.base import constants, logging_, name_resolve, names, network
from areal_tpu_torch.gateway.admission import DEFAULT_BULK_TENANT, AdmissionPlane
from areal_tpu_torch.system import worker_base
from areal_tpu_torch.system.generation_server import GenServerClient

logger = logging_.getLogger("gserver_manager")

#: consecutive failed fabric-epoch scrapes after which a server is
#: declared dead and its fleet-prefix directory entries are dropped (a
#: dead owner must never be advertised as a pull source)
_FABRIC_DEATH_MISSES = 3

#: milliseconds the serve loop waits on its socket for a request before
#: the poll's other duties (version checks, scrapes) run
IDLE_WAIT_MS = 2

#: serve-batch-size histogram buckets (requests drained per ROUTER tick)
_SERVE_BATCH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)


class _ObservedDict(dict):
    """A dict that notifies ``on_set(key)`` on every key write.

    The routing indexes are maintained incrementally off the deltas
    scheduling applies to ``_server_load``/``_server_tokens`` — but
    tests, dryrun harnesses, and operators mutate those maps DIRECTLY
    (``m._server_load.update({...})``).  Observing writes at the dict
    keeps the index honest against every writer without a second code
    path.  Only write paths the load/token/device maps actually use are
    observed (``d[k] = v`` and ``update``); reads are plain dict."""

    __slots__ = ("_on_set",)

    def __init__(self, data, on_set: Callable[[str], None]):
        super().__init__(data)
        self._on_set = on_set

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self._on_set(key)

    def update(self, *args, **kwargs):
        for k, v in dict(*args, **kwargs).items():
            self[k] = v


class _MinHeapIndex:
    """Lazy-deletion min-heap over a fixed server pool.

    Entries are ``(value(addr), pool_index, addr)`` — the pool-index
    tie-break reproduces a linear ``min()`` scan's first-in-pool-order
    winner exactly, so indexed picks are byte-identical to scan picks.
    A write to the underlying map pushes a fresh entry (``touch``);
    stale entries heal at pick time by re-pushing the addr at its
    CURRENT value until the top entry is live.  Membership or device
    changes rebuild the whole index (rare; see
    ``GserverManager._route_index``)."""

    __slots__ = ("_order", "_value", "_heap")

    def __init__(self, pool: List[str], value: Callable[[str], float]):
        self._order = {a: i for i, a in enumerate(pool)}
        self._value = value
        self._heap = [(value(a), i, a) for a, i in self._order.items()]
        heapq.heapify(self._heap)

    def touch(self, addr: str):
        i = self._order.get(addr)
        if i is None:
            return
        heap = self._heap
        heapq.heappush(heap, (self._value(addr), i, addr))
        if len(heap) > 64 + 8 * len(self._order):
            # duplicate entries accumulate one per write; compact before
            # the heap outgrows the pool by an order of magnitude
            self._heap = [
                (self._value(a), j, a) for a, j in self._order.items()
            ]
            heapq.heapify(self._heap)

    def _settle(self):
        """Replace stale top entries with the addr's current value until
        the top is live.  Terminates: each pass converts one stale entry
        and creates none."""
        heap = self._heap
        while heap:
            v, i, a = heap[0]
            cur = self._value(a)
            if v == cur:
                return
            heapq.heapreplace(heap, (cur, i, a))

    def min_value(self) -> float:
        self._settle()
        return self._heap[0][0]

    def pick(self, avoid: Optional[str] = None) -> Optional[str]:
        """The least-valued addr, excluding ``avoid`` — unless ``avoid``
        is the only member, mirroring the scan path's
        ``[a for a in pool if a != avoid] or list(pool)`` fallback."""
        heap = self._heap
        shelved = []
        res = None
        while heap:
            v, i, a = heap[0]
            if a == avoid:
                shelved.append(heapq.heappop(heap))
                continue
            cur = self._value(a)
            if v != cur:
                heapq.heapreplace(heap, (cur, i, a))
                continue
            res = a
            break
        for e in shelved:
            heapq.heappush(heap, e)
        return res if res is not None else avoid


class GserverManager(worker_base.Worker):
    def _configure(self, config: system_api.GserverManagerConfig):
        self.config = config
        self.worker_name = config.worker_name
        self.logger = logging_.getLogger(self.worker_name)

        self._expr = constants.experiment_name()
        self._trial = constants.trial_name()
        if config.schedule_policy not in (
            "round_robin", "least_requests", "least_token_usage",
        ):
            # fail at startup, not as per-request errors mid-training
            raise ValueError(
                f"unknown schedule_policy {config.schedule_policy!r}; "
                "expected round_robin | least_requests | least_token_usage"
            )

        # discover generation servers.  A registration value carries the
        # server's mesh shape (``addr|devices|spec``, see
        # generation_server.format_server_registration): one "server" =
        # one mesh, and every capacity/routing weight below scales with
        # its chip count so a 4-chip TP/EP server absorbs 4x the load
        # of a single-chip peer.
        from areal_tpu_torch.system.generation_server import (
            parse_server_registration,
        )

        values: List[str] = []
        deadline = time.monotonic() + 120
        while len(values) < config.n_servers:
            values = sorted(
                name_resolve.get_subtree(
                    names.gen_servers(self._expr, self._trial)
                )
            )
            if len(values) >= config.n_servers:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"only {len(values)}/{config.n_servers} "
                    "generation servers registered"
                )
            time.sleep(0.1)
        parsed = [parse_server_registration(v) for v in values]
        self.server_addrs = [a for a, _, _, _, _ in parsed]
        self._server_devices: Dict[str, int] = {
            a: d for a, d, _, _, _ in parsed
        }
        self._server_mesh: Dict[str, str] = {
            a: s for a, _, s, _, _ in parsed
        }
        # fleet KV fabric: each server's segment-transport capability
        # (registration token; legacy registrations parse as the
        # host-numpy default).  Pull hints only ever pair servers whose
        # transports match — a d2d server never gets told to pull from
        # a host-numpy one.
        self._server_transport: Dict[str, str] = {
            a: t for a, _, _, _, t in parsed
        }
        # P/D disaggregation: servers register a serving role (prefill |
        # decode | unified; legacy registrations parse as unified).  Two-
        # stage routing activates iff the fleet holds BOTH a prefill and
        # a decode server; prefill servers never OWN a request's resident
        # state (their rows exist only between fill and handoff), so
        # sticky routing, token accounting, and cache affinity all live
        # on the decode pool.  The decode pool is DECODE-ROLE servers
        # only: a decode registration is guaranteed single-process
        # (generation_server validates at configure), while a unified
        # registration carries no such guarantee — a multi-controller
        # SPMD unified server cannot import a handoff unit (it only
        # addresses its local kv-head shard), and routing owners there
        # would make every request pay export + RPC + reject + full
        # re-prefill.  Unified servers in a P/D fleet keep serving
        # whatever reaches them directly, but receive no two-stage
        # traffic.
        self._server_role: Dict[str, str] = {
            a: r for a, _, _, r, _ in parsed
        }
        self._prefill_addrs = [
            a for a in self.server_addrs
            if self._server_role[a] == "prefill"
        ]
        decode_only = [
            a for a in self.server_addrs
            if self._server_role[a] == "decode"
        ]
        self._pd_enabled = bool(self._prefill_addrs) and bool(decode_only)
        self._decode_addrs = (
            decode_only if self._pd_enabled else list(self.server_addrs)
        )
        if self._prefill_addrs and not self._pd_enabled:
            logger.warning(
                "prefill-role servers registered without any decode-role "
                "peer; two-stage P/D routing stays OFF (the fleet serves "
                "unified)"
            )
        if self._pd_enabled and any(
            self._server_role[a] == "unified" for a in self.server_addrs
        ):
            logger.warning(
                "unified-role servers in a P/D fleet receive no "
                "two-stage traffic (handoff owners must be decode-role "
                "servers, whose single-process import capability is "
                "validated at registration)"
            )
        #: rollout group -> its prefill-stage server (group members share
        #: one prompt; colocating their fills lets the engine's block-
        #: reference prompt dedup fire once per group)
        self._group_prefill: Dict[str, str] = {}
        self._pd_rr = 0
        self._init_runtime_state()
        self._clients = {a: GenServerClient(a) for a in self.server_addrs}

        # rollout accounting (reference: monitor.RolloutStat threading
        # through rollout_worker/gserver stats)
        from areal_tpu_torch.base.monitor import RolloutStat

        self._round_robin = 0
        self._qid_server: Dict[str, str] = {}
        self._server_load: Dict[str, int] = {a: 0 for a in self.server_addrs}
        # estimated resident tokens per server (prompt + a discounted new-
        # token budget, reference: realhf/system/gserver_manager.py:400-405);
        # per-qid shares so finish_rollout can release them
        self._server_tokens: Dict[str, float] = {
            a: 0.0 for a in self.server_addrs
        }
        self._qid_tokens: Dict[str, float] = {}
        # rollout group key -> server (group affinity for prompt-KV dedup)
        self._group_server: Dict[str, str] = {}
        # cache-aware routing state: per session (group key), the longest
        # prefix each server has served — the proxy for whose radix cache
        # is hottest for this conversation (the manager never sees token
        # ids; prompt_len of the turns it routed there is the honest
        # lower bound on the prefix that server has cached)
        self._group_prefix: Dict[str, Dict[str, float]] = {}
        # per (group, server) resident-token sums, maintained incrementally
        # alongside _qid_tokens so the imbalance escape hatch's "own load"
        # discount is O(1) per schedule call instead of a scan of every
        # in-flight qid
        self._group_tokens: Dict[str, Dict[str, float]] = {}
        self.rollout_stat = RolloutStat()
        self._model_version = 0

        # service socket: ROUTER (default) drains and replies out of
        # order — legacy REQ clients speak to it unchanged (their
        # [identity, empty, body] envelope is echoed back per reply);
        # "rep" restores the strict-lockstep loop
        mode = getattr(config, "serve_mode", "router") or "router"
        if mode not in ("router", "rep"):
            raise ValueError(
                f"unknown serve_mode {mode!r}; expected router | rep"
            )
        self._serve_mode = mode
        self._ctx = zmq.Context.instance()
        self._sock = self._ctx.socket(
            zmq.ROUTER if mode == "router" else zmq.REP
        )
        port = self._sock.bind_to_random_port("tcp://*")
        self.addr = f"{network.gethostip()}:{port}"
        name_resolve.add(
            names.gen_server_manager(self._expr, self._trial),
            self.addr,
            replace=True,
        )
        self._last_version_check = 0.0
        self._init_metrics()

    def _init_metrics(self):
        """Observability: the staleness gate's whole state becomes
        scrapeable (the paper's §2.4 knobs — queue depth, version lag,
        rejections), and every gate/routing decision lands in the
        flight recorder under the rollout's trace root."""
        from areal_tpu_torch.observability import get_registry
        from areal_tpu_torch.observability import tracing

        # hand-built managers (dryrun, unit tests) reach here without
        # _configure: wire the full runtime state too, not just metrics
        self._init_runtime_state()

        self._tracer = tracing.configure(
            getattr(self.config, "trace", None),
            worker=getattr(self, "worker_name", "gserver_manager"),
        )
        reg = get_registry()
        self._m_rejects = reg.counter("areal_gserver_alloc_rejections_total")
        self._m_running = reg.gauge("areal_gserver_running_rollouts")
        self._m_accepted = reg.counter("areal_gserver_accepted_rollouts_total")
        self._m_version = reg.gauge("areal_gserver_model_version")
        self._m_lag = reg.gauge("areal_gserver_version_lag")
        self._m_srv_reqs = reg.gauge("areal_gserver_server_requests")
        self._m_srv_toks = reg.gauge("areal_gserver_server_tokens")
        self._m_srv_devices = reg.gauge(
            "areal_gserver_server_mesh_devices"
        )
        self._m_affinity_escapes = reg.counter(
            "areal_gserver_affinity_escapes_total"
        )
        # P/D disaggregation: registered servers per role + requests
        # routed through the two-stage prefill->handoff->decode path
        self._m_pd_roles = reg.gauge("areal_gserver_pd_role_servers")
        self._m_pd_routes = reg.counter(
            "areal_gserver_pd_handoff_routes_total"
        )
        # load-aware prefill admission: the backlog estimate each pick
        # routes on, and requests shed to unified-style serving on
        # their decode owner because the whole prefill pool was
        # saturated
        self._m_prefill_backlog = reg.gauge(
            "areal_gserver_prefill_backlog_tokens"
        )
        self._m_prefill_sheds = reg.counter(
            "areal_gserver_prefill_sheds_total"
        )
        # fleet KV fabric: live directory entries (stamped hot-prefix
        # records a hint may cite), pull hints actually emitted, and
        # entries invalidated (weight updates, scraped cache flushes,
        # server death)
        self._m_fabric_entries = reg.gauge(
            "areal_gserver_kv_fabric_directory_entries"
        )
        self._m_fabric_routes = reg.counter(
            "areal_gserver_kv_fabric_pull_routes_total"
        )
        self._m_fabric_invalidations = reg.counter(
            "areal_gserver_kv_fabric_invalidations_total"
        )
        self._m_update_pause = reg.gauge(
            "areal_gserver_weight_update_pause_seconds"
        )
        self._m_updates = reg.counter(
            "areal_gserver_weight_updates_total"
        )
        # SLO plane: schedule wait = how long a rollout sat at the
        # staleness/capacity gate before admission (first rejected
        # allocate -> the eventual ok; 0 when admitted immediately).
        # Fixed log buckets so the master can merge this digest with the
        # engines' TTFT/TPOT families into one fleet row.
        from areal_tpu_torch.observability.latency import SLO_BUCKETS

        self._m_slo_sched = reg.histogram(
            "areal_slo_schedule_wait_seconds", buckets=SLO_BUCKETS
        )
        self._gate_first_reject: Dict[str, float] = {}
        # gateway admission plane: typed per-reason rejects (the same
        # family the gateway's HTTP front door increments — one
        # vocabulary whether a reject happened at the manager or at an
        # in-process gateway backend)
        self._m_gw_rejects = reg.counter(
            "areal_gateway_admission_rejects_total"
        )
        # control plane: requests drained per ROUTER serve tick, the
        # queue depth observed at drain time, and per-command handler
        # cost (count + seconds) — the series that say whether the
        # serve loop itself is the bottleneck
        self._m_ctl_batch = reg.histogram(
            "areal_gserver_control_serve_batch_size",
            buckets=_SERVE_BATCH_BUCKETS,
        )
        self._m_ctl_queue = reg.gauge(
            "areal_gserver_control_queue_depth"
        )
        self._m_ctl_requests = reg.counter(
            "areal_gserver_control_requests_total"
        )
        self._m_ctl_handler_s = reg.counter(
            "areal_gserver_control_handler_seconds_total"
        )
        self._update_pool = None

    def _devices(self, addr: str) -> int:
        """Chip count of a server's mesh (1 for hand-built/legacy
        registrations) — the weight every load signal normalizes by."""
        return getattr(self, "_server_devices", {}).get(addr, 1)

    def _export_metrics(self):
        self._m_running.set(self.rollout_stat.running)
        self._m_version.set(self._model_version)
        self._m_lag.set(self.version_lag())
        for addr in self.server_addrs:
            self._m_srv_reqs.set(self._server_load[addr], server=addr)
            self._m_srv_toks.set(self._server_tokens[addr], server=addr)
            self._m_srv_devices.set(self._devices(addr), server=addr)
        roles = getattr(self, "_server_role", {})
        for role in ("prefill", "decode", "unified"):
            self._m_pd_roles.set(
                sum(1 for r in roles.values() if r == role), role=role
            )
        self._init_runtime_state()
        for addr in getattr(self, "_prefill_addrs", ()):
            self._m_prefill_backlog.set(
                self._prefill_backlog.get(addr, 0.0)
                + self._prefill_backlog_local.get(addr, 0.0),
                server=addr,
            )
        self._m_fabric_entries.set(len(self._fabric_stamp))

    # -- scheduling / staleness --------------------------------------------

    @staticmethod
    def _group_key(qid: str) -> str:
        """Rollout-level key of a member qid: '{qid}-{i}' group members and
        '{qid}@t{j}-{i}' multi-turn members share their rollout's key, so
        the whole group lands on ONE server and the engine's group-prompt
        KV dedup fires (one prefill per group instead of per member).
        Delegates to the flight recorder's trace-root derivation — the
        two MUST agree, or trace assembly and routing affinity group
        members differently (the manager never sees ``#r`` retry ids;
        the extra strip is a no-op here)."""
        from areal_tpu_torch.observability.tracing import member_root

        return member_root(qid)

    def _route_pool(self) -> List[str]:
        """Servers eligible to OWN a request's resident state: everybody
        in a unified fleet; DECODE-ROLE servers only under two-stage P/D
        routing (a prefill server's rows exist only between fill and
        handoff, and a unified registration carries no single-process
        import guarantee — see the _configure comment)."""
        if getattr(self, "_pd_enabled", False):
            return self._decode_addrs
        return self.server_addrs

    def _init_runtime_state(self):
        """Idempotent init of every post-registration runtime map:
        prefill-backlog estimates AND the fleet KV-fabric directory
        state.  ``_configure`` calls it on the normal path;
        ``_init_metrics`` calls it too, so hand-built managers (dryrun,
        unit tests, which used to skip lazily-inited attrs) get the full
        state the moment they wire observability;
        and the hot-path users still call it defensively.  Per-attribute
        guards: a test that pre-seeded one map keeps it."""
        if not hasattr(self, "_prefill_backlog"):
            # load-aware prefill admission: last-scraped prefill-token
            # backlog per prefill server (metrics RPC), plus optimistic
            # local increments since the scrape so a burst between
            # scrapes still spreads instead of piling onto one server.
            # The scrape REPLACES the estimate (it already includes
            # whatever the local adds routed there is still in flight).
            self._prefill_backlog = {
                a: 0.0 for a in getattr(self, "_prefill_addrs", ())
            }
            self._prefill_backlog_local = {
                a: 0.0 for a in getattr(self, "_prefill_addrs", ())
            }
            self._prefill_backlog_ts = 0.0
        if not hasattr(self, "_fabric_stamp"):
            # fleet prefix DIRECTORY: every hot-prefix entry the
            # cache-aware router records is stamped with the owner's
            # (model version, cache-flush epoch) at record time.  A
            # kv_source hint is emitted only while the stamp still
            # matches the CURRENT version and epoch — a weight update,
            # a scraped flush, or a dead server moves them and the
            # directory stops advertising the dropped prefix.
            self._fabric_stamp: Dict[Tuple[str, str], Tuple[int, int]] = {}
            #: last scraped prefix_cache_flushes_total per server (the
            #: flush-epoch signal riding the existing metrics RPC)
            self._server_flush_epoch: Dict[str, float] = {}
            self._fabric_scrape_fut = None
            self._fabric_scrape_ts = 0.0
            #: consecutive failed epoch scrapes per server; at
            #: _FABRIC_DEATH_MISSES the server is declared dead and its
            #: directory entries drop
            self._fabric_scrape_misses: Dict[str, int] = {}
        if not hasattr(self, "_admission"):
            # per-tenant admission plane: gateway requests admit through
            # ``gateway_admit``; rollout traffic charges the default
            # bulk tenant inside ``allocate_rollout``.  Tenant policies
            # come from GserverManagerConfig.tenants (unknown tenants
            # run under the permissive interactive default).
            self._admission = AdmissionPlane.from_config(
                getattr(getattr(self, "config", None), "tenants", ())
            )
        if not hasattr(self, "_state_lock"):
            # guards scheduling state between the serve loop and the
            # async weight-update thread (reentrant: handlers nest)
            self._state_lock = threading.RLock()
        if not hasattr(self, "_route_idx"):
            # O(log N) routing indexes, built lazily on first indexed
            # pick (the load/token maps may not exist yet when
            # _configure first calls here)
            self._route_idx = None
        # observe direct writes to the load/token/device maps so the
        # routing indexes stay honest against every writer (tests and
        # dryrun harnesses mutate these dicts directly)
        if hasattr(self, "_server_load") and not isinstance(
            self._server_load, _ObservedDict
        ):
            self._server_load = _ObservedDict(
                self._server_load, self._touch_load_index
            )
        if hasattr(self, "_server_tokens") and not isinstance(
            self._server_tokens, _ObservedDict
        ):
            self._server_tokens = _ObservedDict(
                self._server_tokens, self._touch_token_index
            )
        if hasattr(self, "_server_devices") and not isinstance(
            self._server_devices, _ObservedDict
        ):
            self._server_devices = _ObservedDict(
                self._server_devices, self._on_devices_write
            )

    # -- O(log N) routing indexes -------------------------------------------

    def _touch_load_index(self, addr: str):
        idx = getattr(self, "_route_idx", None)
        if idx is not None:
            idx["load"].touch(addr)

    def _touch_token_index(self, addr: str):
        idx = getattr(self, "_route_idx", None)
        if idx is not None:
            idx["tokens"].touch(addr)

    def _on_devices_write(self, addr: str):
        # a mesh-shape change moves every per-chip value AND the
        # weighted RR cycle: rebuild wholesale (registration-time rare)
        self._invalidate_route_index()

    def _invalidate_route_index(self):
        self._route_idx = None

    def _route_index(self) -> Dict:
        """The incremental routing indexes over the CURRENT route pool:
        per-chip load and token min-heaps plus the precomputed weighted
        round-robin cycle.  Rebuilt only when the pool object or its
        membership count changes (in-place membership edits must call
        ``_invalidate_route_index``), or when a mesh shape changes (the
        device map is observed).  The heaps self-heal against direct
        writes to the load/token maps via the observed-dict hooks."""
        self._init_runtime_state()
        pool = self._route_pool()
        idx = self._route_idx
        if (
            idx is not None
            and idx["pool"] is pool
            and idx["n"] == len(pool)
        ):
            return idx
        idx = {
            "pool": pool,
            "n": len(pool),
            "load": _MinHeapIndex(
                pool,
                lambda a: self._server_load[a] / self._devices(a),
            ),
            "tokens": _MinHeapIndex(
                pool,
                lambda a: self._server_tokens[a] / self._devices(a),
            ),
            # each server appears once per chip, grouped in pool order,
            # so slicing out an avoided server preserves the exact
            # sequence the per-call rebuild produced
            "cycle": [
                a for a in pool for _ in range(self._devices(a))
            ],
        }
        self._route_idx = idx
        return idx

    def _use_route_index(self) -> bool:
        return bool(getattr(self.config, "routing_index", True))

    def _ensure_update_pool(self):
        """The shared background thread pool (weight-update fan-out,
        backlog/fabric scrapes, the async update driver).  Sized one
        past the client count so the async ``_flush_and_update`` job can
        occupy a worker while its own fan-out subtasks still make
        progress."""
        import concurrent.futures as cf

        if getattr(self, "_update_pool", None) is None:
            self._update_pool = cf.ThreadPoolExecutor(
                max_workers=min(
                    33, max(2, len(getattr(self, "_clients", ())) + 1)
                ),
                thread_name_prefix="weight-update",
            )
        return self._update_pool

    def _refresh_prefill_backlog(self):
        """Keep the prefill-backlog estimates fresh WITHOUT ever
        blocking the scheduling path: at most every
        ``prefill_backlog_refresh_s`` one background scrape of every
        prefill server's ``prefill_backlog_tokens`` (metrics RPC) is
        submitted to the update thread pool, and a FINISHED scrape's
        results are applied on the next call — ``_pick_prefill`` and
        ``_poll`` only ever harvest/submit, never wait.  A successful
        scrape REPLACES that server's estimate and zeroes its local
        increments; a failed or malformed scrape (dead server, an
        ``{"error": ...}`` reply, an older server without the key)
        returns None and keeps the last estimate plus local adds, so a
        broken prefill server never reads as idle."""
        self._init_runtime_state()
        if not getattr(self, "_prefill_addrs", None) or not getattr(
            self, "_clients", None
        ):
            return
        fut = getattr(self, "_backlog_fut", None)
        if fut is not None:
            if not fut.done():
                return  # one scrape in flight at a time
            self._backlog_fut = None
            for addr, backlog in fut.result().items():
                if backlog is not None:
                    self._prefill_backlog[addr] = backlog
                    self._prefill_backlog_local[addr] = 0.0
        now = time.monotonic()
        if now - self._prefill_backlog_ts < max(
            0.05, getattr(self.config, "prefill_backlog_refresh_s", 0.5)
        ):
            return
        self._prefill_backlog_ts = now

        def _scrape_one(addr):
            try:
                m = self._clients[addr].call("metrics", {}, timeout=5.0)
                v = (
                    m.get("prefill_backlog_tokens")
                    if isinstance(m, dict)
                    else None
                )
                if v is None:
                    self.logger.warning(
                        "prefill backlog scrape on %s returned no "
                        "prefill_backlog_tokens (old server?); keeping "
                        "the last estimate", addr,
                    )
                    return None
                return float(v)
            except Exception as e:  # noqa: BLE001 - keep last estimate
                self.logger.warning(
                    "prefill backlog scrape failed on %s: %r", addr, e
                )
                return None

        def _scrape_all(addrs):
            return {a: _scrape_one(a) for a in addrs}

        self._backlog_fut = self._ensure_update_pool().submit(
            _scrape_all, list(self._prefill_addrs)
        )

    def _prefill_backlog_per_chip(self, addr: str) -> float:
        self._init_runtime_state()
        return (
            self._prefill_backlog.get(addr, 0.0)
            + self._prefill_backlog_local.get(addr, 0.0)
        ) / self._devices(addr)

    # -- fleet KV fabric: prefix directory ----------------------------------

    def _transport_of(self, addr: str) -> str:
        """A server's segment-transport capability (registration token;
        hand-built/legacy managers default everything to host-numpy)."""
        return getattr(self, "_server_transport", {}).get(
            addr, "host-numpy"
        )

    def _invalidate_fabric_server(self, addr: str, reason: str):
        """Drop every directory entry owned by ``addr`` (its cache
        flushed, or the server died): the directory must never
        advertise a prefix the owner no longer holds.  Affinity state
        survives — routing a session back to its usual server is still
        right even when the pull hint would be stale."""
        self._init_runtime_state()
        stale = [k for k in self._fabric_stamp if k[1] == addr]
        for k in stale:
            del self._fabric_stamp[k]
        if stale:
            self._m_fabric_invalidations.inc(len(stale), reason=reason)
            self.logger.info(
                "kv fabric: dropped %d directory entries for %s (%s)",
                len(stale), addr, reason,
            )

    def _invalidate_fabric_all(self, reason: str):
        """Weight update: every server flushes both cache tiers, so the
        whole directory AND the hot-prefix affinity sums are stale —
        leaving the sums in place would pin sessions to servers whose
        caches are empty (the stale-affinity bug).  Plain group
        affinity (``_group_server``) and resident-token load survive:
        they track live rows, not cached KV."""
        self._init_runtime_state()
        n = len(self._fabric_stamp)
        self._fabric_stamp.clear()
        for by_srv in getattr(self, "_group_prefix", {}).values():
            by_srv.clear()
        if n:
            self._m_fabric_invalidations.inc(n, reason=reason)

    def _refresh_fabric_epochs(self):
        """Keep the directory honest about evictions WITHOUT blocking
        scheduling: at most every ``prefill_backlog_refresh_s`` one
        background scrape of every route-pool server's
        ``prefix_cache_flushes_total`` (the existing metrics RPC — no
        new engine surface).  An epoch BUMP means the server flushed
        its cache since the last look: its directory entries drop.
        ``_FABRIC_DEATH_MISSES`` consecutive scrape failures declare
        the server dead — same effect.  Harvest-then-submit like the
        backlog scrape: the scheduling path never waits."""
        self._init_runtime_state()
        if not getattr(self.config, "kv_fabric", True):
            return
        if not getattr(self, "_clients", None):
            return
        fut = self._fabric_scrape_fut
        if fut is not None:
            if not fut.done():
                return  # one scrape in flight at a time
            self._fabric_scrape_fut = None
            for addr, epoch in fut.result().items():
                if epoch is None:
                    misses = self._fabric_scrape_misses.get(addr, 0) + 1
                    self._fabric_scrape_misses[addr] = misses
                    if misses == _FABRIC_DEATH_MISSES:
                        self._invalidate_fabric_server(addr, "death")
                    continue
                self._fabric_scrape_misses[addr] = 0
                prev = self._server_flush_epoch.get(addr)
                if prev is not None and epoch > prev:
                    self._invalidate_fabric_server(addr, "flush")
                self._server_flush_epoch[addr] = epoch
        now = time.monotonic()
        if now - self._fabric_scrape_ts < max(
            0.05, getattr(self.config, "prefill_backlog_refresh_s", 0.5)
        ):
            return
        self._fabric_scrape_ts = now

        def _scrape_one(addr):
            try:
                m = self._clients[addr].call("metrics", {}, timeout=5.0)
                v = (
                    m.get("prefix_cache_flushes_total")
                    if isinstance(m, dict)
                    else None
                )
                return None if v is None else float(v)
            except Exception as e:  # noqa: BLE001 - counted as a miss
                self.logger.warning(
                    "kv fabric epoch scrape failed on %s: %r", addr, e
                )
                return None

        def _scrape_all(addrs):
            return {a: _scrape_one(a) for a in addrs}

        self._fabric_scrape_fut = self._ensure_update_pool().submit(
            _scrape_all, list(self._route_pool())
        )

    def _kv_source_hint(
        self,
        qid: str,
        addr: str,
        prompt_len: int,
        prior: Optional[Dict[str, float]] = None,
    ) -> Optional[str]:
        """The peer a request routed to ``addr`` should pull its cached
        prefix from, or None.  Emitted only when every gate holds: the
        fabric is on; some OTHER route-pool server's recorded hot
        prefix for this session beats both the floor
        (``kv_fabric_min_prefix_tokens``) and the routed server's own
        record; the owner's directory stamp still matches the current
        (model version, flush epoch); and both servers speak the same
        segment transport.  Deterministic: candidate owners scan in
        sorted address order, longest prefix wins, ties break on
        address.

        ``prior`` is the group's hot-prefix map SNAPSHOTTED BEFORE this
        turn was scheduled: scheduling optimistically records the whole
        prompt as the routed server's hot prefix, so judging "does a
        peer hold more than the target" against the post-schedule map
        would always answer no — the migration that most needs the pull
        would never get the hint."""
        self._init_runtime_state()
        if not getattr(self.config, "kv_fabric", True):
            return None
        prefixes = (
            prior
            if prior is not None
            else getattr(self, "_group_prefix", {}).get(
                self._group_key(qid)
            )
        )
        if not prefixes:
            return None
        floor = max(
            1.0,
            float(
                getattr(self.config, "kv_fabric_min_prefix_tokens", 256)
            ),
        )
        own = prefixes.get(addr, 0.0)
        group = self._group_key(qid)
        best, best_len = None, 0.0
        for owner in sorted(prefixes):
            plen = prefixes[owner]
            if owner == addr or plen <= best_len:
                continue
            if plen < floor or plen <= own:
                continue
            stamp = self._fabric_stamp.get((group, owner))
            if stamp is None or stamp != (
                self._model_version,
                self._server_flush_epoch.get(owner, 0),
            ):
                continue
            if self._transport_of(owner) != self._transport_of(addr):
                continue
            best, best_len = owner, plen
        return best

    def _pick_prefill(self, group: str, prompt_len: int = 0) -> Optional[str]:
        """Prefill-stage pick — LOAD-AWARE admission over the prefill
        pool.  Group-affine first (every member of a rollout shares one
        prompt, and colocating their fills fires the engine's block-
        reference prompt dedup once per group); otherwise the server
        with the LEAST prefill-token backlog per chip (scraped through
        the metrics RPC + optimistic local increments, so a burst
        between scrapes still spreads).  Returns None — SHED — when
        every prefill server's backlog-per-chip exceeds
        ``prefill_saturation_tokens_per_chip``: the caller routes the
        request straight to its decode owner, which serves it
        unified-style (admission pressure never queues unboundedly on a
        saturated prefill pool).  ``prefill_load_aware=False`` restores
        the chip-weighted rotation (load-blind, never sheds)."""
        cand = self._group_prefill.get(group)
        if cand is not None:
            return cand
        if not getattr(self.config, "prefill_load_aware", True):
            wpool = [
                a for a in self._prefill_addrs
                for _ in range(self._devices(a))
            ]
            addr = wpool[self._pd_rr % len(wpool)]
            self._pd_rr += 1
            self._group_prefill[group] = addr
            return addr
        self._refresh_prefill_backlog()
        sat = getattr(
            self.config, "prefill_saturation_tokens_per_chip", 0
        )
        # deterministic argmin: ties break on address order
        addr = min(
            sorted(self._prefill_addrs),
            key=self._prefill_backlog_per_chip,
        )
        if sat > 0 and self._prefill_backlog_per_chip(addr) > sat:
            self._m_prefill_sheds.inc()
            return None
        self._prefill_backlog_local[addr] = (
            self._prefill_backlog_local.get(addr, 0.0) + float(prompt_len)
        )
        self._group_prefill[group] = addr
        return addr

    def _schedule_request(
        self, qid: str, prompt_len: int = 0, new_token_budget: int = 0
    ) -> Dict:
        """The schedule RPC's full response.  Unified fleets: the owning
        server's url, as ever.  Two-stage P/D fleets: a NEW request is
        routed to a prefill server with ``handoff_to`` naming the decode
        server that owns it — the prefill server fills the row's blocks,
        streams the KV off, and every later continuation sticky-routes
        straight to the decode server.  A saturated prefill pool SHEDS
        the request instead: it serves unified-style on its decode
        owner (``pd_shed`` marks the response)."""
        sticky = qid in self._qid_server  # before _schedule registers it
        # snapshot the session's hot-prefix records BEFORE scheduling:
        # _schedule_inner optimistically records this turn's whole
        # prompt under the routed server, which must not mask a peer's
        # genuinely-resident longer prefix (see _kv_source_hint)
        prior_prefix = dict(
            getattr(self, "_group_prefix", {}).get(
                self._group_key(qid)
            )
            or {}
        )
        addr = self._schedule(qid, prompt_len, new_token_budget)
        resp = {"url": addr, "version": self._model_version}
        if getattr(self, "_pd_enabled", False) and not sticky:
            prefill = self._pick_prefill(
                self._group_key(qid), prompt_len=prompt_len
            )
            if prefill is None:
                resp["pd_shed"] = True
            elif prefill != addr:
                resp["url"] = prefill
                resp["handoff_to"] = addr
                self._m_pd_routes.inc()
                self._tracer.event(
                    qid, "gserver.handoff_route",
                    root=self._group_key(qid),
                    prefill=prefill, decode=addr,
                )
        if "handoff_to" not in resp:
            # fleet KV fabric: the serving target re-prefills this
            # session's context unless a peer's cached prefix can be
            # pulled — name the owner when the directory has a live,
            # longer, transport-compatible entry.  Never alongside a
            # handoff route: there the prefill server streams the KV
            # to the owner anyway.
            source = self._kv_source_hint(
                qid, resp["url"], prompt_len, prior=prior_prefix
            )
            if source is not None:
                resp["kv_source"] = source
                self._m_fabric_routes.inc()
                self._tracer.event(
                    qid, "gserver.kv_fabric_route",
                    root=self._group_key(qid),
                    target=resp["url"], source=source,
                    prompt_len=prompt_len,
                )
        return resp

    def _schedule(
        self, qid: str, prompt_len: int = 0, new_token_budget: int = 0
    ) -> str:
        sticky = qid in self._qid_server  # before _inner registers it
        addr = self._schedule_inner(qid, prompt_len, new_token_budget)
        self._tracer.event(
            qid, "gserver.schedule", root=self._group_key(qid),
            server=addr, sticky=sticky,
            prompt_len=prompt_len, version=self._model_version,
        )
        return addr

    def _schedule_inner(
        self, qid: str, prompt_len: int = 0, new_token_budget: int = 0
    ) -> str:
        if qid in self._qid_server:  # sticky: KV reuse on continuation
            addr = self._qid_server[qid]
            if prompt_len or new_token_budget:
                # refresh the resident-token estimate: a chunked rollout's
                # context grows every continuation, and keeping the first
                # chunk's estimate would let the token-usage policy pile
                # new work onto an actually-full server
                est = float(prompt_len) + 0.4 * float(new_token_budget)
                prev = self._qid_tokens.get(qid, 0.0)
                self._qid_tokens[qid] = est
                self._server_tokens[addr] = max(
                    0.0, self._server_tokens[addr] - prev + est
                )
                gt = self._group_tokens.setdefault(self._group_key(qid), {})
                gt[addr] = max(0.0, gt.get(addr, 0.0) - prev + est)
            return addr
        # cache-aware affinity: a sibling member of this rollout already
        # picked a server (co-locate for group-prompt KV dedup), or an
        # earlier TURN of this conversation left its prefix hot in some
        # server's radix cache — route to the longest-hot-prefix server
        # unless the load-imbalance escape hatch fires
        group = self._group_key(qid)
        sibling, avoid = self._affine_server(group)
        # when the escape hatch fired, `avoid` is the overloaded hot
        # server: the fallback policy must EXCLUDE it, else a policy
        # whose signal differs from the imbalance signal (least_requests
        # on a few-huge-conversations server) re-picks the very server
        # the escape meant to leave
        if sibling is not None:
            addr = sibling
        elif self._use_route_index():
            addr = self._pick_indexed(avoid)
        else:
            addr = self._pick_scan(avoid)
        self._qid_server[qid] = addr
        self._group_server[group] = addr
        if self.config.cache_aware_routing:
            # after this turn the server's radix cache holds (at least)
            # the turn's whole prompt — the hot-prefix estimate future
            # turns of this session route on
            by_srv = self._group_prefix.setdefault(group, {})
            by_srv[addr] = max(by_srv.get(addr, 0.0), float(prompt_len))
            # directory stamp: this entry is advertisable as a pull
            # source only while the owner keeps the (version, epoch) it
            # was recorded under — see _kv_source_hint
            self._init_runtime_state()
            self._fabric_stamp[(group, addr)] = (
                self._model_version,
                self._server_flush_epoch.get(addr, 0),
            )
        self._server_load[addr] += 1
        est = float(prompt_len) + 0.4 * float(new_token_budget)
        self._qid_tokens[qid] = est
        self._server_tokens[addr] += est
        gt = self._group_tokens.setdefault(group, {})
        gt[addr] = gt.get(addr, 0.0) + est
        return addr

    def _pick_scan(self, avoid: Optional[str]) -> str:
        """The original O(N)-over-pool policy picks — kept callable for
        the scan-vs-indexed parity tests and ``routing_index=False``."""
        route_pool = self._route_pool()
        pool = [a for a in route_pool if a != avoid] or list(route_pool)
        if self.config.schedule_policy == "least_requests":
            # PER-CHIP load: a 4-chip mesh server should carry 4x the
            # requests of a single-chip one before looking "busier"
            return min(
                pool, key=lambda a: self._server_load[a] / self._devices(a)
            )
        if self.config.schedule_policy == "least_token_usage":
            # route by estimated resident tokens PER CHIP: prompt + 0.4x
            # budget (the reference's expected-completion discount,
            # gserver_manager :400-405) — a far better KV-pressure signal
            # than request count, normalized by the mesh's capacity
            return min(
                pool,
                key=lambda a: self._server_tokens[a] / self._devices(a),
            )
        # round_robin (policy validated at _configure): weighted cycle —
        # each server appears once per chip, so the rotation hands a
        # 4-chip mesh 4 of every (4+1) requests in a {4-chip, 1-chip}
        # fleet
        wpool = [a for a in pool for _ in range(self._devices(a))]
        addr = wpool[self._round_robin % len(wpool)]
        self._round_robin += 1
        return addr

    def _pick_indexed(self, avoid: Optional[str]) -> str:
        """Index-backed policy picks, pick-for-pick identical to
        ``_pick_scan``: the heaps' pool-index tie-break reproduces the
        scan ``min()``'s first-in-pool-order winner, and the RR cycle is
        grouped per server in pool order so excluding the avoided server
        yields exactly the per-call rebuild's sequence."""
        idx = self._route_index()
        if self.config.schedule_policy == "least_requests":
            return idx["load"].pick(avoid)
        if self.config.schedule_policy == "least_token_usage":
            return idx["tokens"].pick(avoid)
        cycle = idx["cycle"]
        if avoid is not None:
            # escape-hatch path only (rare): materialize the reduced
            # cycle; the common no-avoid pick stays O(1)
            cycle = [a for a in cycle if a != avoid] or cycle
        addr = cycle[self._round_robin % len(cycle)]
        self._round_robin += 1
        return addr

    def _affine_server(
        self, group: str
    ) -> Tuple[Optional[str], Optional[str]]:
        """``(server, avoid)``: the server this session should stick to —
        longest hot prefix (cache-aware) falling back to plain group
        affinity — or, when the imbalance escape hatch fires,
        ``(None, hot_server)`` so the caller re-routes by the configured
        policy EXCLUDING the overloaded hot server (the new server
        re-prefills; a hot cache on an overloaded box is slower than a
        cold one on an idle box)."""
        prefixes = self._group_prefix.get(group)
        if self.config.cache_aware_routing and prefixes:
            # deterministic argmax: ties break on server address order
            cand = max(sorted(prefixes), key=lambda a: prefixes[a])
        else:
            cand = self._group_server.get(group)
        pool = self._route_pool()
        if (
            cand is None
            or not self.config.cache_aware_routing
            or len(pool) <= 1  # nowhere to escape to
        ):
            return cand, None
        # imbalance = FOREIGN load on the hot server: the session's own
        # resident-token estimates are discounted, else a long
        # conversation would eventually evict itself from its hot cache
        # just by growing.  All sides are PER-CHIP: a 4-chip mesh is not
        # "overloaded" for holding 4x a single chip's tokens — and the
        # comparison runs over the ROUTE pool only (a P/D fleet's
        # prefill servers hold ~zero resident tokens by construction
        # and would otherwise trip the escape on every long session).
        own = self._group_tokens.get(group, {}).get(cand, 0.0)
        foreign = (self._server_tokens[cand] - own) / self._devices(cand)
        if self._use_route_index():
            least = self._route_index()["tokens"].min_value()
        else:
            least = min(
                self._server_tokens[a] / self._devices(a) for a in pool
            )
        if foreign > (
            self.config.affinity_imbalance_factor * least
            + self.config.affinity_imbalance_slack_tokens
        ):
            self._m_affinity_escapes.inc()
            return None, cand
        return cand, None

    def get_training_sample_cnt(self) -> int:
        """Globally-trained sample count published by the master
        (reference: realhf/system/gserver_manager.py:344-349).  Unlike a
        local accepted counter this SURVIVES restarts: the master re-seeds
        it from the recovered global_step, so the staleness gate stays
        correct after a recover (a local counter would reset to 0 while
        model_version stays high, silently loosening the bound)."""
        try:
            return int(
                name_resolve.get(
                    names.training_samples(self._expr, self._trial)
                )
            )
        except name_resolve.NameEntryNotFoundError:
            return 0

    def version_lag(self) -> int:
        """expected_version - model_version: how much of the
        max_head_offpolicyness headroom the cluster is consuming right now
        (the series the staleness gate thresholds on).

        The sequences counted are every one generated so far (accepted
        rollouts times ``group_size``; the trainer's loaded-sample counter
        when it is larger, as after a recover) plus the running rollouts'.
        The JAX package counts the loaded samples only, which leaves out
        the trajectories waiting in the trainer's stream queue: when
        rollouts outpace the trainer they pile up there at old versions
        and are trained past the bound."""
        group = max(1, self.config.group_size)
        n_seqs = (
            max(self.get_training_sample_cnt(),
                self.rollout_stat.accepted * group)
            + self.rollout_stat.running * group
        )
        expected_version = n_seqs // max(1, self.config.train_batch_size)
        return expected_version - self._model_version

    def is_staled(self) -> bool:
        """Would a rollout started now exceed the staleness bound?
        (reference: realhf/system/gserver_manager.py:417-453).  In-flight
        rollouts are counted in sequences (``group_size`` per rollout) to
        match ``train_batch_size`` units."""
        return self.version_lag() > self.config.max_head_offpolicyness

    def _allocate_rollout(
        self, qid: str, tokens: float = 0.0, tenant: Optional[str] = None
    ) -> Dict:
        resp = self._allocate_rollout_inner(qid, tokens, tenant)
        # qid here is the ROLLOUT id (its own trace root); the gate
        # decision — including the version-lag headroom it judged — is
        # the first event of a sampled rollout's timeline
        self._tracer.event(
            qid, "gserver.allocate", root=qid,
            ok=resp["ok"], reason=resp["reason"],
            version_lag=self.version_lag(),
        )
        return resp

    def _allocate_rollout_inner(
        self, qid: str, tokens: float = 0.0, tenant: Optional[str] = None
    ) -> Dict:
        self._init_runtime_state()
        cap = self.config.max_concurrent_rollouts or 10**9
        if self.rollout_stat.running >= cap:
            self._m_rejects.inc(reason="capacity")
            self._gate_first_reject.setdefault(qid, time.monotonic())
            return {"ok": False, "reason": "capacity"}
        if self.is_staled():
            self._m_rejects.inc(reason="staled")
            self._gate_first_reject.setdefault(qid, time.monotonic())
            return {"ok": False, "reason": "staled"}
        # the tenant admission plane gates rollouts too: rollout traffic
        # charges the default bulk tenant (permissive unless the
        # operator configured a "rollout" policy), so serving quota
        # storms and training throttles share one accounting surface
        tenant = tenant or DEFAULT_BULK_TENANT
        dec = self._admission.admit(
            tenant, float(tokens), time.monotonic()
        )
        if not dec.ok:
            self._m_rejects.inc(reason=dec.reason)
            self._gate_first_reject.setdefault(qid, time.monotonic())
            resp = {"ok": False, "reason": dec.reason}
            if dec.retry_after_s:
                resp["retry_after_s"] = dec.retry_after_s
            return resp
        self.rollout_stat.submitted += 1
        self.rollout_stat.running += 1
        # schedule wait: gate-queueing latency of this rollout (0 when
        # it was never rejected) — the SLO plane's head-of-pipeline term
        t0 = self._gate_first_reject.pop(qid, None)
        self._m_slo_sched.observe(
            0.0 if t0 is None else max(0.0, time.monotonic() - t0),
            workload=str(tenant),
        )
        return {"ok": True, "reason": ""}

    def _finish_rollout(self, qid: str, accepted: bool):
        self._tracer.event(
            qid, "gserver.finish", root=qid, accepted=accepted
        )
        self.rollout_stat.running = max(0, self.rollout_stat.running - 1)
        if accepted:
            self.rollout_stat.accepted += 1
            self._m_accepted.inc()
        self._release_scheduled(qid)

    def _release_scheduled(self, qid: str):
        """Sweep every scheduling record a request (rollout OR gateway)
        registered.  Scheduling registered per-group-member qids
        "{qid}-{i}"; multi-turn agents prefix per-turn requests as
        "{qid}@t{j}" before the member suffix, so both derived forms
        must be swept."""
        for k in [
            k
            for k in self._qid_server
            if k == qid or k.startswith(qid + "-") or k.startswith(qid + "@")
        ]:
            srv = self._qid_server.pop(k)
            self._server_load[srv] = max(0, self._server_load[srv] - 1)
            self._server_tokens[srv] = max(
                0.0, self._server_tokens[srv] - self._qid_tokens.pop(k, 0.0)
            )
        self._group_server.pop(qid, None)
        self._group_prefix.pop(qid, None)
        self._group_tokens.pop(qid, None)
        for k in [
            k
            for k in getattr(self, "_fabric_stamp", {})
            if k[0] == qid
        ]:
            del self._fabric_stamp[k]
        getattr(self, "_group_prefill", {}).pop(qid, None)
        # a rollout abandoned between reject and ok must not leak its
        # gate stamp (and must not pollute a later same-qid rollout)
        self._gate_first_reject.pop(qid, None)

    # -- weight updates -----------------------------------------------------

    def _check_new_params(self) -> Optional[Dict]:
        """Poll name_resolve for a newly-published model version
        (reference :131; the trainer publishes after each train step)."""
        try:
            raw = name_resolve.get(
                names.model_version(self._expr, self._trial, "actor")
            )
        except name_resolve.NameEntryNotFoundError:
            return None
        info = pickle.loads(bytes.fromhex(raw)) if isinstance(raw, str) else raw
        if info["version"] <= self._model_version:
            return None
        return info

    def _update_one_server(
        self, addr: str, client, payload: Dict, timeout: Optional[float] = None
    ):
        """Per-server ``update_weights`` with bounded-backoff retries: a
        TRANSIENT RPC failure (timeout, connection reset, a server busy
        draining a long chunk) on ONE server must not fail the whole
        fleet's version bump.  A server-side rejection (the client
        raises ``RuntimeError`` for an ``{"error": ...}`` response, e.g.
        a bad checkpoint path) reproduces on every attempt and fails the
        server IMMEDIATELY — commit/full calls run while the WHOLE fleet
        is paused, so each attempt is also capped at
        ``flush_request_timeout`` (stage calls pass the longer
        ``stage_request_timeout``: decode continues while they run).
        Returns the success response dict, or the failure (exception
        repr / bad response) once retries are spent."""
        retries = max(1, self.config.update_weights_retries)
        backoff = max(0.0, self.config.update_weights_retry_backoff_s)
        if timeout is None:
            timeout = self.config.flush_request_timeout
        #: stage replies carry "staged"; commit/full replies carry
        #: "num_interrupted" — either marks success
        ok_keys = ("num_interrupted", "staged")
        last = None
        for attempt in range(retries):
            if attempt:
                time.sleep(min(backoff * (2 ** (attempt - 1)), 10.0))
            try:
                resp = client.call(
                    "update_weights",
                    payload,
                    timeout=timeout,
                )
            except (TimeoutError, ConnectionError, OSError) as e:
                last = repr(e)
                self.logger.warning(
                    "update_weights attempt %d/%d on %s failed: %s",
                    attempt + 1, retries, addr, last,
                )
                continue
            except Exception as e:  # noqa: BLE001 - deterministic reject
                last = repr(e)
                self.logger.warning(
                    "update_weights on %s rejected (not retried): %s",
                    addr, last,
                )
                return last
            if isinstance(resp, dict) and any(k in resp for k in ok_keys):
                return resp
            # a malformed (non-error, non-success) response reproduces
            # too: report it without burning paused-fleet time on retries
            last = resp
            self.logger.warning(
                "update_weights on %s returned %r (not retried)", addr, resp
            )
            return last
        return last

    def _fan_out(self, fn, items):
        """Run ``fn(addr, client)`` for every server CONCURRENTLY on a
        persistent thread pool and return ``{addr: result}``.  The pool
        is long-lived so the clients' thread-local sockets are reused
        across rounds instead of churning one DEALER per call.  ``fn``
        must not raise (the update/pause/resume wrappers below return
        failures as values)."""
        items = list(items)
        if len(items) <= 1:
            return {addr: fn(addr, client) for addr, client in items}
        import concurrent.futures as cf

        pool = self._ensure_update_pool()
        futs = {
            pool.submit(fn, addr, client): addr
            for addr, client in items
        }
        return {futs[f]: f.result() for f in cf.as_completed(futs)}

    def _flush_and_update(self, info: Dict):
        """Push a newly published version to every generation server.

        Staged protocol (``staged_weight_updates``, sharded snapshots):
          1. ``mode="stage"`` to ALL servers concurrently — each restores
             the snapshot into a device-resident staging tree while its
             decode loop keeps emitting tokens; the RPC returns once the
             tree is resident (the pre-pause barrier).
          2. pause the fleet (concurrent), ``mode="commit"`` (a pointer
             flip + next-step ring drain; version-checked server-side so
             the barrier is version-consistent), resume — the fleet
             pause is max(commit) across servers instead of
             sum(load + transfer + apply).
          3. a server whose stage failed takes the legacy full reload
             INSIDE the pause window, so the fleet still converges on
             one version; any remaining failure withholds the version
             bump exactly like the legacy path.

        Legacy protocol (flag off, or an HF-format cross-job swap):
        pause, concurrent full ``update_weights``, resume.

        Under the ROUTER serve loop this runs OFF the serve thread (see
        ``_start_weight_update``): only the final version-bump +
        directory-invalidation step touches scheduling state, under the
        state lock — the slow RPC fan-out never blocks scheduling."""
        self._init_runtime_state()
        version = info["version"]
        payload = {
            "path": info["path"],
            "version": version,
            # forward the checkpoint format so servers pick the
            # sharded raw-param load path for orbax trees
            "format": info.get("format"),
        }
        staged = bool(
            getattr(self.config, "staged_weight_updates", False)
            and info.get("format") == "params"
        )
        items = list(self._clients.items())
        stage_ok: Dict[str, Dict] = {}
        if staged:
            # phase 1 — decode continues fleet-wide while every server
            # restores its shards concurrently
            res = self._fan_out(
                lambda addr, client: self._update_one_server(
                    addr,
                    client,
                    {**payload, "mode": "stage"},
                    timeout=self.config.stage_request_timeout,
                ),
                items,
            )
            stage_failed = []
            for addr, r in res.items():
                if isinstance(r, dict) and "staged" in r:
                    stage_ok[addr] = r
                else:
                    stage_failed.append((addr, r))
            if stage_failed:
                self.logger.warning(
                    "weight staging v%d failed on %d/%d servers (%s); "
                    "they take the full reload inside the pause window",
                    version, len(stage_failed), len(items),
                    stage_failed[:2],
                )

        def _pause(addr, client):
            try:
                client.call("pause", {})
                return True
            except Exception as e:  # noqa: BLE001 - recorded as failure
                return repr(e)

        def _resume(addr, client):
            # servers must NEVER stay paused — even if an update errored
            try:
                client.call("resume", {})
                return True
            except Exception:  # noqa: BLE001 - keep resuming the rest
                self.logger.exception("resume failed on %s", addr)
                return False

        def _commit(addr, client):
            if staged and addr in stage_ok:
                # server-side barrier wait strictly inside the RPC
                # timeout: a commit must answer (success or failure)
                # before the client gives up, or the timeout-retry races
                # an already-applied flip
                commit_timeout = max(
                    5.0, 0.5 * self.config.flush_request_timeout
                )
                return self._update_one_server(
                    addr, client,
                    {
                        **payload,
                        "mode": "commit",
                        "commit_timeout": commit_timeout,
                    },
                )
            return self._update_one_server(addr, client, payload)

        n_interrupted = 0
        failed = []
        t_pause = time.monotonic()
        pause_res = self._fan_out(_pause, items)
        try:
            for addr, r in pause_res.items():
                if r is not True:
                    self.logger.warning("pause failed on %s: %s", addr, r)
            res = self._fan_out(_commit, items)
            for addr, r in res.items():
                if isinstance(r, dict) and "num_interrupted" in r:
                    n_interrupted += r["num_interrupted"]
                else:
                    failed.append((addr, r))
        finally:
            self._fan_out(_resume, items)
        pause_seconds = time.monotonic() - t_pause
        self._m_update_pause.set(pause_seconds)
        self._m_updates.inc(mode="staged" if staged else "full")
        if failed:
            # leave _model_version unchanged: the poll loop retries on the
            # next (or same) published version instead of deadlocking
            self.logger.error(
                "weight update v%d failed on %d/%d servers: %s",
                version,
                len(failed),
                len(self._clients),
                failed[:2],
            )
            return
        with self._state_lock:
            self._model_version = version
            # the fleet-wide flush that just happened emptied every
            # cache tier: drop the prefix directory AND the hot-prefix
            # affinity sums (leaving them would pin sessions to servers
            # whose caches are empty — the stale-affinity bug — and
            # would let the directory advertise flushed prefixes until
            # the next epoch scrape noticed)
            self._invalidate_fabric_all("weight_update")
        self.logger.info(
            "weights updated to v%d on %d servers (%d interrupted, "
            "%s, fleet paused %.3fs)",
            version,
            len(self._clients),
            n_interrupted,
            "staged" if staged else "full",
            pause_seconds,
        )

    # -- poll ---------------------------------------------------------------

    def _gateway_admit(self, payload: Dict) -> Dict:
        """The tenant admission decision for one gateway request."""
        self._init_runtime_state()
        tenant = str(payload["tenant"])
        dec = self._admission.admit(
            tenant,
            float(payload.get("tokens", 0.0)),
            time.monotonic(),
        )
        if not dec.ok:
            self._m_gw_rejects.inc(reason=dec.reason)
        root = str(payload.get("qid") or tenant)
        self._tracer.event(
            root, "gserver.gateway_admit", root=root,
            tenant=tenant, ok=dec.ok, reason=dec.reason,
        )
        return dec.as_dict()

    def _gateway_submit(self, payload: Dict) -> Dict:
        """Admission AND schedule in ONE round trip: the gateway's
        per-request ``gateway_admit`` + ``schedule_request`` pair
        collapsed into a single manager call.  An admitted decision
        carries the schedule response under ``"schedule"``; a rejected
        one is exactly the ``gateway_admit`` reject (no placement is
        registered, so there is nothing to release on reject)."""
        resp = self._gateway_admit(payload)
        if resp.get("ok") and payload.get("qid"):
            resp["schedule"] = self._schedule_request(
                str(payload["qid"]),
                int(payload.get("prompt_len", 0)),
                int(payload.get("new_token_budget", 0)),
            )
        return resp

    def _handle_request(self, cmd: str, payload: Dict):
        """One command's response — shared by the REP and ROUTER serve
        loops (and callable directly by tests/bench without a socket).
        Raises on malformed payloads; the serve loops turn exceptions
        into ``{"error": ...}`` replies."""
        if cmd == "schedule_request":
            return self._schedule_request(
                payload["qid"],
                payload.get("prompt_len", 0),
                payload.get("new_token_budget", 0),
            )
        if cmd == "schedule_batch":
            # group siblings' first chunks in one RPC: one lock pass,
            # one round trip (affinity co-locates them anyway).
            # Payload: {"qids": [...], "prompt_len", "new_token_budget"}
            # (siblings share one prompt), responses in qid order.
            return {
                "responses": [
                    self._schedule_request(
                        str(q),
                        payload.get("prompt_len", 0),
                        payload.get("new_token_budget", 0),
                    )
                    for q in payload.get("qids", ())
                ]
            }
        if cmd == "allocate_rollout":
            return self._allocate_rollout(
                payload["qid"],
                float(payload.get("tokens", 0.0)),
                payload.get("tenant"),
            )
        if cmd == "gateway_admit":
            return self._gateway_admit(payload)
        if cmd == "gateway_submit":
            return self._gateway_submit(payload)
        if cmd == "gateway_finish":
            self._init_runtime_state()
            self._admission.settle(
                str(payload["tenant"]),
                float(payload.get("reserved_tokens", 0.0)),
                float(payload.get("used_tokens", 0.0)),
            )
            if payload.get("qid"):
                self._release_scheduled(str(payload["qid"]))
            return "ok"
        if cmd == "gateway_reset_budget":
            self._init_runtime_state()
            self._admission.reset_budget(str(payload["tenant"]))
            return "ok"
        if cmd == "finish_rollout":
            self._finish_rollout(
                payload["qid"], payload.get("accepted", True)
            )
            return "ok"
        if cmd == "get_status":
            self._init_runtime_state()
            return {
                "version": self._model_version,
                "n_running_rollouts": self.rollout_stat.running,
                "accepted_rollouts": self.rollout_stat.accepted,
                **{
                    f"rollout_stat/{k}": v
                    for k, v in self.rollout_stat.as_dict().items()
                },
                "server_load": dict(self._server_load),
                "server_tokens": dict(self._server_tokens),
                "server_mesh_devices": {
                    a: self._devices(a) for a in self.server_addrs
                },
                "server_roles": dict(
                    getattr(self, "_server_role", {})
                ),
                "pd_enabled": getattr(self, "_pd_enabled", False),
                "prefill_backlog_tokens": {
                    a: self._prefill_backlog.get(a, 0.0)
                    + self._prefill_backlog_local.get(a, 0.0)
                    for a in getattr(self, "_prefill_addrs", ())
                },
                "kv_fabric_directory_entries": len(
                    self._fabric_stamp
                ),
                "server_transports": dict(
                    getattr(self, "_server_transport", {})
                ),
                "tenants": self._admission.stats(),
            }
        return {"error": f"unknown command {cmd}"}

    def _dispatch(self, body: bytes):
        """Decode one wire message, run its handler, meter it.  Never
        raises: failures become the ``{"error": ...}`` response the
        client raises RuntimeError on."""
        t0 = time.monotonic()
        cmd = "?"
        try:
            cmd, payload = pickle.loads(body)
            resp = self._handle_request(cmd, payload)
        except Exception as e:  # noqa: BLE001
            self.logger.exception("request failed")
            resp = {"error": repr(e)}
        self._m_ctl_requests.inc(cmd=str(cmd))
        self._m_ctl_handler_s.inc(time.monotonic() - t0, cmd=str(cmd))
        return resp

    def _serve(self):
        if getattr(self, "_serve_mode", "rep") == "router":
            return self._serve_router()
        return self._serve_rep()

    def _serve_rep(self):
        """Legacy strict-lockstep REP loop (serve_mode="rep")."""
        if not self._sock.poll(timeout=IDLE_WAIT_MS):
            return 0
        n = 0
        for _ in range(64):
            try:
                msg = self._sock.recv(flags=zmq.NOBLOCK)
            except zmq.ZMQError:
                break
            with self._state_lock:
                resp = self._dispatch(msg)
            self._sock.send(pickle.dumps(resp))
            n += 1
        return n

    def _serve_router(self):
        """Concurrent batched serve loop: drain every pending request
        (up to ``serve_batch_max``) off the ROUTER socket, process the
        whole batch under ONE lock pass, and reply per request as
        computed — replies go out in arrival order here, but the socket
        is free to interleave clients, so a storm of slow-to-drain
        peers never wedges the strict REP lockstep.  Each request's
        [identity, ...] envelope frames are echoed back verbatim, which
        is exactly what a legacy REQ client expects."""
        sock = self._sock
        cap = max(1, int(getattr(self.config, "serve_batch_max", 256)))
        # wait for a request on the socket (releasing Python's lock) rather
        # than spin: in one process with the port's host-bound decode loop,
        # a spinning poll thread takes the lock from the server's thread
        if not sock.poll(timeout=IDLE_WAIT_MS):
            self._m_ctl_queue.set(0.0)
            return 0
        batch = []
        while len(batch) < cap:
            try:
                batch.append(sock.recv_multipart(flags=zmq.NOBLOCK))
            except zmq.ZMQError:
                break
        self._m_ctl_queue.set(float(len(batch)))
        if not batch:
            return 0
        self._m_ctl_batch.observe(float(len(batch)))
        with self._state_lock:
            for parts in batch:
                *envelope, body = parts
                resp = self._dispatch(body)
                try:
                    sock.send_multipart(
                        envelope + [pickle.dumps(resp)],
                        flags=zmq.NOBLOCK,
                    )
                except zmq.ZMQError:
                    # unroutable identity (client vanished) or a full
                    # send queue: drop the reply — the client's timeout
                    # path discards its socket and retries
                    self.logger.warning(
                        "dropped reply to a vanished/stalled client"
                    )
        return len(batch)

    def _harvest_weight_update(self):
        """Reap a finished async weight-update job (surfacing its
        exception to the log); leaves an unfinished one running."""
        fut = getattr(self, "_weight_update_fut", None)
        if fut is None or not fut.done():
            return
        self._weight_update_fut = None
        try:
            fut.result()
        except Exception:  # noqa: BLE001 - next poll retries the version
            self.logger.exception("async weight update crashed")

    def _start_weight_update(self, info: Dict):
        """Run the weight-update fan-out OFF the serve thread (ROUTER
        mode): the minutes-long stage/pause/commit RPC round must never
        stall scheduling.  One update in flight at a time — while it
        runs, ``_check_new_params`` keeps returning the pending (or a
        newer) version and the next poll picks it up after harvest.
        REP mode keeps the legacy inline call (hand-built managers and
        the A/B baseline depend on its synchronous semantics)."""
        if getattr(self, "_serve_mode", "rep") != "router":
            self._flush_and_update(info)
            return
        if getattr(self, "_weight_update_fut", None) is not None:
            return
        self._weight_update_fut = self._ensure_update_pool().submit(
            self._flush_and_update, info
        )

    def _poll(self) -> worker_base.PollResult:
        served = self._serve()
        # harvest/kick the background prefill-backlog and fabric-epoch
        # scrapes even when no schedule traffic arrives (never block —
        # see the methods)
        self._refresh_prefill_backlog()
        self._refresh_fabric_epochs()
        if time.monotonic() - self._last_version_check > 0.5:
            self._last_version_check = time.monotonic()
            self._harvest_weight_update()
            info = self._check_new_params()
            if info is not None:
                self._start_weight_update(info)
            self._export_metrics()
        return worker_base.PollResult(sample_count=served)

    def _exit_hook(self):
        # a swap round still in flight must not outlive the manager: its
        # RPCs wait up to stage_request_timeout, and the interpreter joins
        # the pool's threads at exit; closed clients fail them at once
        for client in getattr(self, "_clients", {}).values():
            client.close()
        pool = getattr(self, "_update_pool", None)
        if pool is not None:
            pool.shutdown(wait=False)
        if hasattr(self, "_sock"):
            self._sock.close(linger=0)


class GserverManagerClient:
    """Blocking REQ client used by rollout workers and the gateway.

    REQ speaks to BOTH manager serve modes: the ROUTER loop echoes the
    REQ envelope back per reply, so this client never changed when the
    serve loop did.  ``addr`` skips name_resolve discovery (bench
    harnesses and tests that bind their own manager socket)."""

    def __init__(
        self,
        experiment_name: Optional[str] = None,
        trial_name: Optional[str] = None,
        timeout=60.0,
        addr: Optional[str] = None,
    ):
        if addr is None:
            addr = name_resolve.wait(
                names.gen_server_manager(experiment_name, trial_name),
                timeout=120,
            )
        self._ctx = zmq.Context.instance()
        import threading

        self._local = threading.local()
        self.addr = addr
        self.timeout = timeout
        self._abort = threading.Event()

    def _sock(self):
        import threading

        if not hasattr(self._local, "sock"):
            s = self._ctx.socket(zmq.REQ)
            s.connect(f"tcp://{self.addr}")
            self._local.sock = s
        return self._local.sock

    def call(self, cmd: str, payload: Dict):
        from areal_tpu_torch.system.generation_server import _poll_abortable

        sock = self._sock()
        sock.send(pickle.dumps((cmd, payload)))
        if not _poll_abortable(sock, self.timeout, self._abort):
            # a REQ socket is stuck in recv state after a timeout: discard it
            # so the next call starts clean (the late reply is dropped)
            sock.close(linger=0)
            del self._local.sock
            if self._abort.is_set():
                raise TimeoutError(f"{cmd}: manager client closed")
            raise TimeoutError(f"{cmd} to gserver manager timed out")
        resp = pickle.loads(sock.recv())
        if isinstance(resp, dict) and "error" in resp:
            raise RuntimeError(resp["error"])
        return resp

    def close(self):
        self._abort.set()  # unblock in-flight executor threads promptly
        if hasattr(self._local, "sock"):
            self._local.sock.close(linger=0)
