"""The port's generation server against the JAX package's: each runs in a
thread on its own memory name_resolve, on the same weights (the JAX
server's random init, converted for the port), and is driven over ZMQ by
its own package's client.

* The same greedy requests give the same tokens, logprobs within 1e-4 and
  versions on both servers.
* Each side publishes the same v1 in its own format (an orbax tree, a
  safetensors file; both cast to bfloat16) and runs the manager's staged
  round over RPC: stage while a request decodes, pause, commit, resume.
  The request in flight ends with a v0 prefix and a v1 tail, and the same
  requests give the same outputs again, all under v1.
* A retried commit is acknowledged; a stage of the version already served
  is dropped; the metrics reply carries the swap counters and the SLO
  digests.
* What the port does not serve is refused with ``NotImplementedError``.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.models import transformer as jt
from areal_tpu.models.config import tiny_config
from areal_tpu_torch.models.convert import params_from_jax
from tests.test_torch_model import port_config

TOL = 1e-4
EXPR, TRIAL = "gsparity", "t0"
MODEL_ARGS = {"vocab_size": 64, "max_position_embeddings": 256, "seed": 0}
SERVER = dict(
    worker_name="gen_server_0", max_concurrent_batch=4, kv_cache_len=128,
    cache_mode="paged", page_size=16, chunk_size=8, prefill_chunk_tokens=32,
    greedy=True, stage_chunk_bytes=16 * 1024,
)
PROMPT_LENS = (3, 20, 33, 9)
BUDGETS = (17, 9, 23, 12)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class Side:
    """One package's server, its client and its request/snapshot types."""

    def __init__(self, name, worker, thread, client, make_input, ck, weights):
        self.name, self.worker, self.thread = name, worker, thread
        self.client, self.make_input, self.ck = client, make_input, ck
        self.weights = weights  # v1, in this package's own tree form

    @property
    def engine(self):
        return self.worker.engine

    def generate_all(self, prompts, tag, budgets=BUDGETS):
        """The requests sent concurrently, one client thread each."""
        outs = [None] * len(prompts)

        def one(i):
            outs[i] = self.client.generate(
                self.make_input(f"{tag}{i}", prompts[i], budgets[i]))

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert all(o is not None for o in outs), f"{self.name}: lost a reply"
        return outs

    def update(self, mode, path, version=1, **kw):
        return self.client.call("update_weights", dict(
            path=path, version=version, format="params", mode=mode, **kw))


def _start_jax(jtree1):
    from areal_tpu.api.config import ModelAbstraction
    from areal_tpu.api.model_api import (
        APIGenerateInput,
        GenerationHyperparameters,
    )
    from areal_tpu.api.system_api import GenServerConfig
    from areal_tpu.base import constants, name_resolve, names
    from areal_tpu.engine import checkpoint
    from areal_tpu.system.generation_server import (
        GenerationServerWorker,
        GenServerClient,
        parse_server_registration,
    )

    name_resolve.reconfigure("memory")
    constants.set_experiment_trial_names(EXPR, TRIAL)
    worker = GenerationServerWorker()
    cfg = GenServerConfig(model=ModelAbstraction("random", dict(MODEL_ARGS)),
                          **SERVER)
    t = threading.Thread(target=worker.run, args=(cfg,), daemon=True)
    t.start()
    addr = parse_server_registration(name_resolve.wait(
        names.gen_server(EXPR, TRIAL, SERVER["worker_name"]), timeout=60))[0]

    def make_input(qid, p, b):
        return APIGenerateInput(
            qid=qid, prompt_ids=list(p), input_ids=list(p),
            gconfig=GenerationHyperparameters(max_new_tokens=b, greedy=True))

    return Side("jax", worker, t, GenServerClient(addr, timeout=60),
                make_input, checkpoint, jtree1)


def _start_port(monkeypatch, np_tree0, tree1):
    from areal_tpu_torch.api.config import ModelAbstraction
    from areal_tpu_torch.api.model_api import (
        APIGenerateInput,
        GenerationHyperparameters,
    )
    from areal_tpu_torch.api.system_api import GenServerConfig
    from areal_tpu_torch.base import constants, name_resolve, names
    from areal_tpu_torch.engine import backend, checkpoint
    from areal_tpu_torch.system.generation_server import (
        GenerationServerWorker,
        GenServerClient,
        parse_server_registration,
    )

    real = backend.make_model

    def make_model(cfg, name, mesh=None, tokenizer=None, device=None):
        # the port's random init draws torch's numbers: serve the JAX
        # server's weights instead
        model = real(cfg, name, mesh, tokenizer=tokenizer, device=device)
        model.init_params = params_from_jax(np_tree0, model.model_cfg, device)
        return model

    monkeypatch.setattr(backend, "make_model", make_model)
    name_resolve.reconfigure("memory")
    constants.set_experiment_trial_names(EXPR, TRIAL)
    worker = GenerationServerWorker()
    cfg = GenServerConfig(model=ModelAbstraction("random", dict(MODEL_ARGS)),
                          device="cpu", **SERVER)
    t = threading.Thread(target=worker.run, args=(cfg,), daemon=True)
    t.start()
    addr = parse_server_registration(name_resolve.wait(
        names.gen_server(EXPR, TRIAL, SERVER["worker_name"]), timeout=60))[0]

    def make_input(qid, p, b):
        return APIGenerateInput(
            qid=qid, prompt_ids=list(p), input_ids=list(p),
            gconfig=GenerationHyperparameters(max_new_tokens=b, greedy=True))

    return Side("port", worker, t, GenServerClient(addr, timeout=60),
                make_input, checkpoint, tree1)


@pytest.fixture(scope="module")
def sides():
    mp = pytest.MonkeyPatch()
    jcfg = tiny_config(vocab_size=64, max_position_embeddings=256)
    np_tree0 = jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(0)))
    np_tree1 = jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(42)))
    jside = _start_jax(jax.tree.map(jnp.asarray, np_tree1))
    pside = _start_port(mp, np_tree0,
                        params_from_jax(np_tree1, port_config(jcfg), "cpu"))
    yield jside, pside
    for side in (jside, pside):
        side.client.close()
        side.worker.exit()
        side.thread.join(30)
        assert not side.thread.is_alive(), f"{side.name} server did not exit"
    mp.undo()


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(6, 64, n).tolist() for n in PROMPT_LENS]


def _assert_same(port_outs, jax_outs):
    for a, b in zip(port_outs, jax_outs):
        assert a.qid == b.qid and a.output_ids == b.output_ids
        np.testing.assert_allclose(a.output_logprobs, b.output_logprobs,
                                   rtol=TOL, atol=TOL)
        assert (a.version_start, a.version_end, a.no_eos) == (
            b.version_start, b.version_end, b.no_eos)
        assert a.output_versions == [b.version_end] * len(b.output_ids)


def test_same_requests_same_outputs_at_v0(sides):
    jside, pside = sides
    prompts = _prompts()
    got = pside.generate_all(prompts, "a")
    ref = jside.generate_all(prompts, "a")
    _assert_same(got, ref)
    assert all(o.version_end == 0 for o in got)


def test_staged_swap_over_rpc_then_same_outputs(sides, tmp_path):
    """The manager's round on each side: stage while a request decodes,
    pause, commit, resume; then the same requests again, under v1."""
    jside, pside = sides
    long_prompt = [7, 8, 9, 10]
    for side in (jside, pside):
        snap = str(tmp_path / side.name / "v1")
        cast = "bfloat16" if side.name == "jax" else torch.bfloat16
        side.ck.save_params(side.weights, snap, cast_dtype=cast)
        side.ck.write_manifest(side.weights, snap, version=1)
        side.snap = snap
        box = {}

        def long_request(side=side, box=box):
            box["out"] = side.client.generate(
                side.make_input("long", long_prompt, 100))

        t = threading.Thread(target=long_request)
        t.start()
        eng = side.engine
        while eng.n_decoding == 0 and t.is_alive():
            time.sleep(0.001)
        reply = side.update("stage", snap)
        assert reply["staged"] == 1 and reply["stage_seconds"] >= 0
        assert eng.staged_version == 1 or eng.version == 1
        assert side.client.call("pause", {}) == "paused"
        reply = side.update("commit", snap)
        assert reply["num_interrupted"] in (0, 1)
        assert side.client.call("resume", {}) == "resumed"
        t.join(60)
        out = box["out"]
        # decoded under v0 up to the swap (or finished before it)
        assert out.version_start == 0 and out.version_end in (0, 1)
        # the swap applies at the server's next step after the resume
        deadline = time.monotonic() + 30
        while eng.version != 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.version == 1 and eng.staged_version is None
        if side is pside:
            k = sum(v == 0 for v in out.output_versions)
            assert out.output_versions == [0] * k + [1] * (
                len(out.output_ids) - k)
            assert k > 0 and (k < len(out.output_ids)) == (
                out.version_end == 1)
    prompts = _prompts()
    got = pside.generate_all(prompts, "b")
    ref = jside.generate_all(prompts, "b")
    _assert_same(got, ref)
    assert all(o.version_start == 1 for o in got)
    assert pside.engine.swap_stats()["swaps_staged_total"] == 1
    assert jside.engine.swap_stats()["swaps_staged_total"] == 1


def test_commit_retry_and_stale_stage(sides):
    """After the round: a retried commit of v1 is acknowledged, a stage of
    v1 (already served) is dropped, and serving goes on under v1."""
    jside, pside = sides
    for side in (jside, pside):
        assert side.engine.version == 1, "runs after the staged round"
        reply = side.update("commit", side.snap)
        assert reply == {"num_interrupted": 0, "version": 1}
        reply = side.update("stage", side.snap)
        assert reply["staged"] == 1
        assert side.engine.staged_version is None  # stale: dropped
        with pytest.raises(RuntimeError, match="server error"):
            side.update("commit", side.snap, version=2)
    prompts = _prompts(1)[:2]
    _assert_same(pside.generate_all(prompts, "c", BUDGETS[:2]),
                 jside.generate_all(prompts, "c", BUDGETS[:2]))


def test_metrics_carry_swap_counters_and_slo_digests(sides):
    jside, pside = sides
    got = pside.client.call("metrics", {})
    ref = jside.client.call("metrics", {})
    for m in (got, ref):
        assert m["version"] == 1
        assert m["swap_swaps_total"] >= 1 and m["swap_swaps_staged_total"] >= 1
        assert m["swap_stage_s"] > 0 and m["swap_pause_s"] > 0
        assert m["slo"]["records_total"] >= len(PROMPT_LENS)
        assert set(m["slo_digests"]) == {
            "admission_wait_s", "ttft_s", "tpot_s", "stall_s"}
    for k in ("n_inflight", "n_pending", "gen_tokens_total",
              "prefix_cache_hits_total", "cancelled_total", "role"):
        assert got[k] == ref[k], k
    assert got["slo"]["records_total"] == ref["slo"]["records_total"]
    assert got["decode_chunks_total"] > 0


def test_cancel_and_refused_commands(sides):
    jside, pside = sides
    assert pside.client.call("stream_cancel", {"qid": "nobody"}) == {"ok": True}
    for cmd in ("generate_stream", "stream_poll", "import_handoff",
                "export_prefix"):
        with pytest.raises(RuntimeError, match="NotImplementedError"):
            pside.client.call(cmd, {"qid": "x"})
    assert pside.engine.version == 1


@pytest.mark.parametrize("mode", ["full", "stage"])
def test_update_weights_from_an_hf_dir_serves_its_weights(
        sides, tmp_path, mode):
    """``update_weights`` with ``format="hf"`` swaps in an HF checkpoint
    directory, in one call or through the staged round; the server then
    gives the greedy tokens of an engine built on the directory's weights.
    A directory of another architecture is refused before any read."""
    from areal_tpu_torch.engine.inference_server import (
        ContinuousBatchingEngine,
    )
    from areal_tpu_torch.engine.sampling import SamplingParams
    from areal_tpu_torch.models.convert import serving_params
    from areal_tpu_torch.models.hf import load_hf_model, save_hf_model
    from areal_tpu_torch.models.transformer import init_params
    from chip_smoke import serve

    _, pside = sides
    eng = pside.engine
    version = eng.version + 1
    hf_dir = str(tmp_path / "hf")
    save_hf_model(hf_dir, "llama", eng.cfg,
                  init_params(eng.cfg, version, "cpu", dtype=torch.float32))
    other = str(tmp_path / "other")
    wide = dataclasses.replace(eng.cfg, intermediate_dim=96)
    save_hf_model(other, "llama", wide,
                  init_params(wide, 0, "cpu", dtype=torch.float32))
    with pytest.raises(RuntimeError, match="not the served architecture"):
        pside.client.call("update_weights", dict(
            path=other, version=version, format="hf", mode=mode))
    payload = dict(path=hf_dir, version=version, format="hf")
    if mode == "full":
        reply = pside.client.call("update_weights", dict(payload, mode=mode))
        assert reply["num_interrupted"] == 0
    else:
        reply = pside.client.call("update_weights",
                                  dict(payload, mode="stage"))
        assert reply["staged"] == version
        assert pside.client.call("pause", {}) == "paused"
        pside.client.call("update_weights", dict(payload, mode="commit"))
        assert pside.client.call("resume", {}) == "resumed"
    prompts = _prompts(version)
    got = pside.generate_all(prompts, f"hf{version}")
    assert eng.version == version
    assert all(o.version_start == o.version_end == version for o in got)

    cfg, params = load_hf_model(hf_dir, dtype=eng.cfg.dtype, device="cpu")
    ref = ContinuousBatchingEngine(
        cfg, serving_params(params, cfg), max_batch=4, kv_cache_len=128,
        cache_mode="paged", page_size=16, chunk_size=8,
        prefill_chunk_tokens=32, sampling=SamplingParams(greedy=True),
        device="cpu")
    want, _ = serve(ref, [pside.make_input(f"ref{i}", p, b) for i, (p, b)
                          in enumerate(zip(prompts, BUDGETS))])
    for a, b in zip(got, want):
        assert a.output_ids == b.output_ids
        np.testing.assert_allclose(a.output_logprobs, b.output_logprobs,
                                   rtol=TOL, atol=TOL)


def test_engine_cancel_releases_rows():
    """``cancel`` frees a request wherever it lives: pending, decoding,
    parked, or finished but not collected."""
    from areal_tpu_torch.api.model_api import (
        APIGenerateInput,
        GenerationHyperparameters,
    )
    from areal_tpu_torch.engine.inference_server import (
        ContinuousBatchingEngine,
    )
    from areal_tpu_torch.models.config import tiny_config as ttiny
    from areal_tpu_torch.models.transformer import init_params

    cfg = ttiny(vocab_size=64)
    eng = ContinuousBatchingEngine(
        cfg, init_params(cfg, 0, "cpu"), max_batch=2, kv_cache_len=64,
        chunk_size=4, cache_mode="paged", page_size=16, device="cpu")

    def req(q, n):
        return APIGenerateInput(qid=q, prompt_ids=[1, 2, 3],
                                input_ids=[1, 2, 3],
                                gconfig=GenerationHyperparameters(
                                    max_new_tokens=n))

    for q in ("a", "b", "c"):
        eng.submit(req(q, 40))
    for _ in range(3):
        eng.step()
    assert eng.cancel("a") and eng.cancel("c")  # decoding, pending
    assert not eng.cancel("nobody")
    while eng.has_work:
        eng.step()
    assert eng.cancel("b")  # finished and parked, result not collected
    assert eng.drain_results() == {} and eng.cancelled_total == 3
    assert eng.close() == {}
    eng._prefix_cache.flush()
    assert eng.free_pool_blocks == eng.n_blocks


@pytest.mark.parametrize("kw", [
    dict(role="prefill"),
    dict(role="decode"),
    dict(num_processes=2),
    dict(mesh_spec=type("Mesh", (), {"world_size": 2})()),
    dict(compile_quiet_after_steps=8),
    dict(spec_decode="spec"),
    dict(serving_weight_dtype="int8"),
    dict(prefix_cache_host_bytes=1 << 20),
    dict(cache_mode="dense"),
], ids=["prefill", "decode", "processes", "mesh", "compile_watch", "spec",
        "int8_weights", "host_tier", "dense"])
def test_out_of_slice_options_are_refused(kw):
    """The P/D roles, multi-process servers, meshes and the compile watch
    are refused; speculative decoding, int8 weights, the host tier and the
    dense cache configure a server whose engine holds them."""
    from areal_tpu_torch.api.config import ModelAbstraction
    from areal_tpu_torch.api.system_api import GenServerConfig, SpecDecodeConfig
    from areal_tpu_torch.base import constants, name_resolve
    from areal_tpu_torch.system.generation_server import GenerationServerWorker

    if kw.get("spec_decode") == "spec":
        kw = dict(spec_decode=SpecDecodeConfig(enabled=True))
    cfg = GenServerConfig(
        model=ModelAbstraction("random", dict(MODEL_ARGS)), device="cpu",
        **dict(SERVER, worker_name="gen_server_options", **kw))
    key = next(iter(kw))
    if key not in ("spec_decode", "serving_weight_dtype",
                   "prefix_cache_host_bytes", "cache_mode"):
        with pytest.raises(NotImplementedError):
            GenerationServerWorker().configure(cfg)
        return
    name_resolve.reconfigure("memory")
    constants.set_experiment_trial_names(EXPR, "options")
    worker = GenerationServerWorker()
    worker.configure(cfg)
    try:
        eng, m = worker.engine, worker.metrics()
        if key == "spec_decode":
            assert eng._spec is not None and m["spec_verify_chunks_total"] == 0
        elif key == "serving_weight_dtype":
            assert m["weight_quant_quantized"] == 1
            assert m["weight_quant_storage_bits"] == 8
        elif key == "prefix_cache_host_bytes":
            assert m["prefix_cache_host_bytes_budget"] == 1 << 20
        else:
            assert m["cache_mode"] == "dense" and m["preempted_total"] == 0
    finally:
        worker._exit_hook()


def test_registration_round_trip():
    from areal_tpu.base.topology import MeshSpec
    from areal_tpu.system import generation_server as jgs
    from areal_tpu_torch.system import generation_server as tgs

    assert tgs.format_server_registration("h:1", None) == (
        jgs.format_server_registration("h:1", MeshSpec()))
    for value in ("h:1", "h:1|1|d1f1m1p1s1e1", "h:1|4|spec|decode|tpu-d2d",
                  "h:1|2|spec|weird"):
        assert tgs.parse_server_registration(value) == (
            jgs.parse_server_registration(value))


def test_worker_server_control_and_status():
    """A ``Worker`` behind its ``WorkerServer``: configured, started and
    stopped over the REQ command socket, its status and heartbeat keys in
    the port's name_resolve."""
    import pickle

    import zmq

    from areal_tpu_torch.base import name_resolve, names
    from areal_tpu_torch.system import worker_base

    name_resolve.reconfigure("memory")

    class Counter(worker_base.Worker):
        def _configure(self, config):
            self.polls, self.config = 0, config

        def _poll(self):
            self.polls += 1
            return worker_base.PollResult(sample_count=1)

    server = worker_base.make_server("w0", "ctl", "t0")
    worker = Counter(server)
    t = threading.Thread(target=worker.run, daemon=True)
    t.start()
    sock = zmq.Context.instance().socket(zmq.REQ)
    sock.connect(f"tcp://{name_resolve.get(names.worker('ctl', 't0', 'w0'))}")

    def request(cmd, **kw):
        sock.send(pickle.dumps((cmd, kw)))
        assert sock.poll(10000), cmd
        return pickle.loads(sock.recv())

    try:
        assert request("ping") == ("ok", "pong")
        assert request("configure", config={"k": 1}) == ("ok", "configured")
        assert request("start") == ("ok", "started")
        deadline = time.monotonic() + 10
        while (getattr(worker, "polls", 0) < 3
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert worker.polls >= 3 and worker.config == {"k": 1}
        assert request("status") == ("ok", "RUNNING")
        assert request("nonsense")[0] == "error"
        assert float(name_resolve.get(
            names.worker_heartbeat("ctl", "t0", "w0"))) > 0
        assert request("exit") == ("ok", "exiting")
        t.join(10)
        assert not t.is_alive()
        assert name_resolve.get(
            names.worker_status("ctl", "t0", "w0")) == "COMPLETED"
    finally:
        sock.close(linger=0)


def test_start_served_before_the_config_is_applied_stands():
    """The run loop applies a config from its queue after serving the
    commands that came with it: a "start" among them stands."""
    from areal_tpu_torch.base import name_resolve
    from areal_tpu_torch.system import worker_base

    name_resolve.reconfigure("memory")
    server = worker_base.make_server("w1", "ctl", "t1")

    class Idle(worker_base.Worker):
        def _configure(self, config):
            self.config = config

    worker = Idle(server)
    try:
        assert worker._on_start() == "started"
        worker.configure({"k": 1})
        assert server.status == worker_base.WorkerServerStatus.RUNNING
    finally:
        server.close()


def test_free_ports_are_distinct_and_registered():
    from areal_tpu.base import network as jnet
    from areal_tpu_torch.base import name_resolve, names, network

    name_resolve.reconfigure("memory")
    ports = network.find_free_ports(3, experiment_name="ports",
                                    trial_name="t0")
    assert len(set(ports)) == 3
    root = names.used_ports("ports", "t0", network.gethostname())
    assert sorted(int(v) for v in name_resolve.get_subtree(root)) == sorted(
        ports)
    # a later search skips the registered ports
    more = network.find_free_ports(2, experiment_name="ports",
                                   trial_name="t0")
    assert not set(more) & set(ports)
    assert network.gethostname() == jnet.gethostname()
    assert network.gethostip() == "127.0.0.1"


@pytest.mark.parametrize("restore_on", ["stage_thread", "poll_thread"])
def test_stage_reply_counts_the_decode_work_of_its_restore(
        tmp_path, monkeypatch, restore_on):
    """The stage reply counts the decode steps the poll loop enqueued while
    the stage thread restored.  The control holds the poll loop for the
    restore (the poll thread waits the stage thread out): it shows none.
    The restore lasts until a decode step was enqueued, or 2 s."""
    from areal_tpu_torch.api.config import ModelAbstraction
    from areal_tpu_torch.api.model_api import (
        APIGenerateInput,
        GenerationHyperparameters,
    )
    from areal_tpu_torch.api.system_api import GenServerConfig
    from areal_tpu_torch.base import constants, name_resolve, names
    from areal_tpu_torch.engine import checkpoint
    from areal_tpu_torch.system.generation_server import (
        GenerationServerWorker,
        GenServerClient,
        parse_server_registration,
    )

    name_resolve.reconfigure("memory")
    constants.set_experiment_trial_names("gsstage", restore_on.replace("_", ""))
    worker = GenerationServerWorker()
    cfg = GenServerConfig(
        model=ModelAbstraction("random", dict(MODEL_ARGS,
                                              max_position_embeddings=1024)),
        device="cpu", **dict(SERVER, kv_cache_len=512))
    t = threading.Thread(target=worker.run, args=(cfg,), daemon=True)
    t.start()
    client = None
    try:
        addr = parse_server_registration(name_resolve.wait(
            names.gen_server(constants.experiment_name(),
                             constants.trial_name(), SERVER["worker_name"]),
            timeout=60))[0]
        client = GenServerClient(addr, timeout=60)
        eng = worker.engine
        snap = str(tmp_path / "v1")
        checkpoint.save_params(eng.params, snap)
        checkpoint.write_manifest(eng.params, snap, version=1)

        real = checkpoint.load_params_staged

        def slow_restore(*args, **kwargs):
            s0 = eng.decode_steps_total
            deadline = time.monotonic() + 2
            while (eng.decode_steps_total == s0
                   and time.monotonic() < deadline):
                time.sleep(0.002)
            return real(*args, **kwargs)

        monkeypatch.setattr(checkpoint, "load_params_staged", slow_restore)
        if restore_on == "poll_thread":
            begin = worker._begin_stage

            def held(payload):
                begin(payload)
                worker._staging["thread"].join()

            monkeypatch.setattr(worker, "_begin_stage", held)
        outs = []
        gen = [threading.Thread(target=lambda i=i: outs.append(client.generate(
            APIGenerateInput(qid=f"s{i}", prompt_ids=[7, 8, 9 + i],
                             input_ids=[7, 8, 9 + i],
                             gconfig=GenerationHyperparameters(
                                 max_new_tokens=400, greedy=True)))))
            for i in range(4)]
        for g in gen:
            g.start()
        while eng.n_decoding == 0:
            time.sleep(0.001)
        reply = client.call("update_weights", dict(
            path=snap, version=1, format="params", mode="stage"))
        assert reply["staged"] == 1 and eng.staged_version == 1
        if restore_on == "stage_thread":
            assert reply["decode_steps_during_stage"] >= 1, reply
        else:
            assert reply["decode_steps_during_stage"] == 0, reply
            assert reply["decode_tokens_during_stage"] == 0, reply
        for g in gen:
            g.join(60)
        assert len(outs) == 4 and all(o.version_end == 0 for o in outs)
    finally:
        if client is not None:
            client.close()
        worker.exit()
        t.join(30)
    assert not t.is_alive()
