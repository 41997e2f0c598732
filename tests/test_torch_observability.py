"""The port's observability plane against the JAX package's:

* the canonical tables (metrics, trace names, stall kinds) entry for
  entry, and the registry's label check against them;
* the HBM ledger: one scripted operation sequence gives the same
  snapshot, watermarks, leaks, reconciliation and rendered gauges; the
  port's ``tree_nbytes`` counts each torch storage once;
* the compile watch: both watches fed one scripted ``_cache_size``
  sequence give the same new-compile counts, counters, sentinel fires and
  callbacks; the port's entries count loaded kernel libraries and its
  backend signal takes each load's build seconds;
* the per-worker HTTP server: ``/metrics``, ``/healthz``, ``/trace``,
  ``/profile`` (a ``torch.profiler`` capture of CPU activity here) and its
  409 while a capture runs, the name_resolve registrations, and the
  ``WorkerServer`` that starts one.
"""

import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from areal_tpu.observability import compile_watch as jcw
from areal_tpu.observability import hbm_ledger as jled
from areal_tpu.observability import registry as jreg
from areal_tpu.observability import table as jtable
from areal_tpu.observability import tracing as jtr
from areal_tpu_torch.observability import compile_watch as tcw
from areal_tpu_torch.observability import hbm_ledger as tled
from areal_tpu_torch.observability import registry as treg
from areal_tpu_torch.observability import table as ttable
from areal_tpu_torch.observability import tracing as ttr


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- the tables ---------------------------------------------------------------


def test_tables_match_the_jax_package_entry_for_entry():
    def metrics(mod):
        return [(s.name, s.type, tuple(s.labels)) for s in mod.METRIC_TABLE
                if s.name not in getattr(mod, "PORT_ONLY_METRICS", ())]

    assert metrics(ttable) == metrics(jtable)
    # the port's own series are not the JAX package's
    assert not set(ttable.PORT_ONLY_METRICS) & set(jtable.table_index())
    assert [(s.name, s.kind) for s in ttable.TRACE_TABLE] == [
        (s.name, s.kind) for s in jtable.TRACE_TABLE]
    assert ttable.STALL_KINDS == jtable.STALL_KINDS
    assert set(ttable.table_index()) == set(jtable.table_index()) | set(
        ttable.PORT_ONLY_METRICS)
    assert set(ttable.trace_table_index()) == set(jtable.trace_table_index())
    for mod in (ttable, jtable):
        assert mod.stall_kind("recompile") == "recompile"
        with pytest.raises(ValueError, match="unknown stall kind"):
            mod.stall_kind("nope")
    # the help text names the port's mechanism where the JAX one names XLA
    spec = ttable.table_index()["areal_xla_compiles_total"]
    assert "library" in spec.help and "XLA" not in spec.help


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_registry_checks_label_keys_against_the_table(pkg):
    reg = (treg if pkg == "port" else jreg).MetricsRegistry()
    c = reg.counter("areal_xla_compiles_total")
    c.inc(fn="paged_decode_chunk")
    with pytest.raises(ValueError, match="declares labels"):
        c.inc(kind="x")
    with pytest.raises(ValueError, match="declares labels"):
        reg.gauge("areal_hbm_ledger_bytes").set(1.0)
    assert c.help  # from the table
    # a name outside the table takes any label set
    reg.gauge("untabled_test_gauge").set(1.0, anything="x")
    assert "untabled_test_gauge" in reg.render()


# -- the HBM ledger -------------------------------------------------------------


def _ledger_script(led_mod, reg_mod):
    led = led_mod.HbmLedger()
    led.register("weights", 1000, name="w")
    led.register("kv_pool", 4096)
    staged = led.register("staged_weights")
    staged.resize(900)
    staged.resize(300)
    spill = led.register("prefix_spill_host", 64)
    handoff = led.register("handoff_staging", 10)
    base = led.snapshot()
    led.register("stream_buffers", 40)
    handoff.release()
    handoff.release()  # a second release is a no-op
    handoff.resize(99)  # and so is a resize after it
    spill.set(0)
    with pytest.raises(ValueError, match="unknown ledger subsystem"):
        led.register("nope")
    reg = reg_mod.MetricsRegistry()
    out = dict(
        snapshot=led.snapshot(), peak=led.watermarks(), leaks=led.leaks(base),
        leaks_empty=led.leaks(), device=led.device_bytes(),
        ok=led.reconcile(reg, 10_000),
        drift=led.reconcile(reg, 100, tolerance_bytes=0),
        vacuous=led.reconcile(reg, None),
    )
    led.publish(reg)
    out["render"] = "\n".join(
        line for line in reg.render().splitlines() if "hbm_ledger" in line)
    off = led_mod.HbmLedger(enabled=False)
    h = off.register("weights", 5)
    h.resize(7)
    out["disabled"] = (off.snapshot(), h.bytes)
    return out


def test_ledger_matches_the_jax_package():
    got = _ledger_script(tled, treg)
    assert got == _ledger_script(jled, jreg)
    assert got["leaks"] == {"stream_buffers": 40, "handoff_staging": -10,
                            "prefix_spill_host": -64}
    assert got["drift"]["drift_gb"] > 0 and not got["drift"]["ok"]
    assert got["vacuous"]["vacuous"] and got["ok"]["ok"]
    assert tled.SUBSYSTEMS == jled.SUBSYSTEMS
    assert tled.DEVICE_SUBSYSTEMS == jled.DEVICE_SUBSYSTEMS
    assert tled.DRIFT_TOLERANCE_BYTES == jled.DRIFT_TOLERANCE_BYTES


def test_tree_nbytes_counts_each_storage_once():
    pool = torch.zeros(2, 3, 16)
    # the K and V views of one buffer are one allocation
    assert tled.tree_nbytes([pool[0], pool[1]]) == pool.numel() * 4
    emb = torch.zeros(10, 4, dtype=torch.bfloat16)
    tied = {"embed": {"w": emb}, "head": {"w": emb.t()}, "n": None, "k": 3}
    assert tled.tree_nbytes(tied) == 80
    assert tled.tree_nbytes({"m": torch.empty(5, 5, device="meta")}) == 0
    # distinct arrays: the JAX package's count, leaf by leaf
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 5)).astype(np.float32),
            "b": [rng.integers(0, 9, 7).astype(np.int32)]}
    port_tree = {"a": torch.from_numpy(tree["a"]),
                 "b": [torch.from_numpy(tree["b"][0])]}
    assert tled.tree_nbytes(port_tree) == jled.tree_nbytes(tree) == 88
    assert tled.tree_nbytes(tree) == 88  # numpy leaves count their nbytes


def test_monitor_reconciles_vacuously_without_a_card():
    from areal_tpu_torch.base import monitor
    from areal_tpu_torch.observability import get_registry

    reg = get_registry()
    reg.gauge("areal_hbm_ledger_drift_gb").set(3.0)
    assert monitor.device_memory_stats() == {}
    assert reg.gauge("areal_hbm_ledger_drift_gb").value() == 0.0


# -- the compile watch -----------------------------------------------------------


class _Entry:
    """A watched entry whose cache size follows a script."""

    def __init__(self, sizes):
        self.sizes, self.i = list(sizes), 0

    def _cache_size(self):
        return self.sizes[min(self.i, len(self.sizes) - 1)]


#: per poll: (engine step, size of entry A, size of entry B)
_SCRIPT = [(1, 1, 0), (2, 2, 0), (3, 2, 1), (4, 2, 1), (5, 3, 1), (6, 4, 3),
           (7, 4, 3), (8, 5, 3), (9, 5, 3)]


def _watch_script(cw_mod, reg_mod, tr_mod):
    reg = reg_mod.MetricsRegistry()
    fires = []
    watch = cw_mod.CompileWatch(
        registry=reg, tracer=tr_mod.Tracer(), quiet_after_steps=4,
        on_steady_compile=fires.append, monitoring=False)
    a, b = _Entry([s[1] for s in _SCRIPT]), _Entry([s[2] for s in _SCRIPT])
    assert watch.watch("paged_fill_chunk", a, signature=lambda: "sig")
    assert watch.watch("paged_decode_chunk", b)
    assert not watch.watch("no_cache", object())
    polls = []
    for i, (step, _, _) in enumerate(_SCRIPT):
        a.i = b.i = i + 1 if i + 1 < len(_SCRIPT) else i
        watch.note_step(step)
        polls.append((watch.steady, watch.armed, watch.poll()))
    watch.set_steady(False)
    render = [line for line in reg.render().splitlines()
              if line.startswith(("areal_xla_compiles_total",
                                  "areal_trace_stall_total"))]
    return dict(polls=polls, stats=watch.stats(), fires=fires, render=render)


def test_compile_watch_matches_the_jax_package():
    got = _watch_script(tcw, treg, ttr)
    assert got == _watch_script(jcw, jreg, jtr)
    # the steady-state episodes: loads on consecutive polls are one alarm,
    # a quiet poll re-arms the sentinel
    assert got["stats"]["xla_sentinel_fires_total"] == 2
    assert got["stats"]["xla_steady_compiles_total"] == 5
    assert got["fires"] == [["paged_fill_chunk"], ["paged_fill_chunk"]]


def test_library_entries_and_the_load_signal(monkeypatch):
    from areal_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "LOADED", {})
    entry = tcw.library_entry("paged_attention", "paged_attention_deep")
    reg = treg.MetricsRegistry()
    watch = tcw.CompileWatch(registry=reg, tracer=ttr.Tracer(),
                             quiet_after_steps=2)
    assert watch.monitoring_active and watch.watch("decode", entry)
    assert watch.cache_sizes() == {"decode": 0}
    watch.note_step(2)
    _build.LOADED["paged_attention_deep"] = object()
    for fn in list(_build._load_listeners):
        fn("paged_attention_deep", 2.5)  # what load_library tells
    assert watch.poll() == {"decode": 1}
    assert watch.sentinel_fires_total == 1 and watch.cache_sizes() == {
        "decode": 1}
    assert reg.counter("areal_xla_compiles_total").value(fn="backend") == 1
    assert reg.histogram("areal_xla_compile_seconds").snapshot()[0] == 2.5
    watch.close()


# -- the HTTP server ---------------------------------------------------------------


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def test_metrics_server_routes_profile_and_registration(tmp_path):
    from areal_tpu_torch.base import name_resolve, names
    from areal_tpu_torch.observability import prom_text
    from areal_tpu_torch.observability.server import MetricsServer

    name_resolve.reconfigure("memory")
    reg = treg.MetricsRegistry()
    reg.gauge("areal_hbm_ledger_bytes").set(123.0, subsystem="kv_pool")
    tracer = ttr.Tracer(ttr.TraceConfig(sample_rate=1.0))
    tracer.event("q0", "engine.admit", row=0)
    srv = MetricsServer(registry=reg, tracer=tracer,
                        capture_dir=str(tmp_path)).start()
    srv.worker_name = "gen_server_0"
    key = srv.register("obs", "t0", "gen_server_0")
    assert key == names.metric_server("obs", "t0", "gen_server", "gen_server_0")
    base = f"http://{name_resolve.get(key)}"
    try:
        code, ctype, body = _get(base + "/metrics")
        assert code == 200 and ctype.startswith("text/plain; version=0.0.4")
        fam = prom_text.parse(body.decode())["areal_hbm_ledger_bytes"]
        assert [(s.labels, s.value) for s in fam.samples] == [
            ({"subsystem": "kv_pool"}, 123.0)]
        code, _, body = _get(base + "/healthz")
        health = json.loads(body)
        assert code == 200 and health["worker"] == "gen_server_0"
        assert health["status"] == "ok" and health["uptime_s"] >= 0
        code, _, body = _get(base + "/trace?since=0")
        assert code == 200 and any(
            e["name"] == "engine.admit" for e in json.loads(body)["events"])
        assert _get(base + "/nope")[0] == 404

        # a capture: one in flight; the second request gets 409
        code, _, body = _get(base + "/profile?seconds=0.5")
        started = json.loads(body)
        assert code == 200 and started["status"] == "started"
        code, _, body = _get(base + "/profile?seconds=0.5")
        assert code == 409 and json.loads(body)["status"] == "busy"
        assert name_resolve.get(names.profiler_capture(
            "obs", "t0", "gen_server_0")) == started["path"]
        deadline = time.monotonic() + 60
        while srv.profile_status()["state"] == "running":
            assert time.monotonic() < deadline
            torch.ones(64, 64) @ torch.ones(64, 64)  # CPU activity
            time.sleep(0.02)
        status = json.loads(_get(base + "/profile?status=1")[2])
        assert status["state"] == "done", status
        assert os.path.dirname(status["trace"]) == status["path"]
        with open(status["trace"]) as f:
            assert "traceEvents" in json.load(f)
    finally:
        srv.stop()
    with pytest.raises(name_resolve.NameEntryNotFoundError):
        name_resolve.get(key)


def test_worker_server_serves_metrics():
    from areal_tpu_torch.base import name_resolve, names
    from areal_tpu_torch.system import worker_base

    name_resolve.reconfigure("memory")
    server = worker_base.make_server("model_worker_0", "obs", "t1")
    try:
        assert server.metrics_server is not None
        key = names.metric_server("obs", "t1", "model_worker",
                                  "model_worker_0")
        _, _, body = _get(f"http://{name_resolve.get(key)}/metrics")
        assert b'areal_worker_info{group="model_worker",worker=' \
            b'"model_worker_0"} 1' in body
        server.note_activity()
    finally:
        server.close()
    assert server.metrics_server is None
    with pytest.raises(name_resolve.NameEntryNotFoundError):
        name_resolve.get(key)
