"""The port's rollout system against the JAX package's, on the same inputs:

* ``GserverManager``: the same seeded event sequences (allocate, schedule
  with group members and continuations, finish, trained-sample counter
  bumps, weight versions) through a hand-built manager of each package
  give the same decisions: the staleness and capacity gates, routing,
  token accounting; and a weight-update round reaches fake servers in the
  same order (stage, pause, commit, resume), with the same fallbacks when
  a stage or a commit fails.
* ``PartialRolloutManager`` with fake manager and server clients gives the
  same chunked continuations (every request the server sees) and the same
  versions; the port's also carries every token's version across chunks.
* The math single-step agent with the math environment gives the same
  trajectories and rewards on fixed answers (right, wrong, unboxed).
* ``math_code_prompt`` gives the same token ids in the same order from the
  same seed and shard.
"""

import asyncio
import json
import logging

import numpy as np
import pytest
import torch

from areal_tpu.api import model_api as jmodel_api
from areal_tpu.api import system_api as jsystem_api
from areal_tpu.base import monitor as jmonitor
from areal_tpu.base import name_resolve as jname_resolve
from areal_tpu.base import names as jnames
from areal_tpu.system import gserver_manager as jgm
from areal_tpu.system import partial_rollout as jpr
from areal_tpu_torch.api import model_api as tmodel_api
from areal_tpu_torch.api import system_api as tsystem_api
from areal_tpu_torch.base import monitor as tmonitor
from areal_tpu_torch.base import name_resolve as tname_resolve
from areal_tpu_torch.base import names as tnames
from areal_tpu_torch.system import gserver_manager as tgm
from areal_tpu_torch.system import partial_rollout as tpr
from tests.fixtures import (  # noqa: F401
    dataset,
    dataset_path,
    save_path,
    tokenizer,
    tokenizer_path,
)

PKGS = {
    "jax": (jgm, jsystem_api, jmonitor, jname_resolve, jnames),
    "torch": (tgm, tsystem_api, tmonitor, tname_resolve, tnames),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _manager(pkg, policy="least_requests", **cfg):
    """A manager of ``pkg`` without its ZMQ service (the JAX package's unit
    tests build theirs the same way), on a fresh in-memory name_resolve."""
    gm, system_api, monitor, nr, _ = PKGS[pkg]
    nr.reconfigure("memory")
    m = gm.GserverManager.__new__(gm.GserverManager)
    m.config = system_api.GserverManagerConfig(
        schedule_policy=policy, n_servers=3, **cfg)
    m.server_addrs = ["s0", "s1", "s2"]
    m.logger = logging.getLogger(f"test-gm-{pkg}")
    m._round_robin = 0
    m._qid_server = {}
    m._server_load = {a: 0 for a in m.server_addrs}
    m._server_tokens = {a: 0.0 for a in m.server_addrs}
    m._server_devices = {a: 1 for a in m.server_addrs}
    m._server_mesh = {a: "" for a in m.server_addrs}
    m._qid_tokens = {}
    m._group_server = {}
    m._group_prefix = {}
    m._group_tokens = {}
    m.rollout_stat = monitor.RolloutStat()
    m._model_version = 0
    m._expr, m._trial = "test-exp", "test-trial"
    m._init_metrics()
    return m


def _replay(pkg, events, **cfg):
    """Every decision the manager takes over ``events``."""
    _, _, _, nr, names = PKGS[pkg]
    m = _manager(pkg, **cfg)
    out = []
    for ev in events:
        kind = ev[0]
        if kind == "alloc":
            r = m._allocate_rollout(ev[1])
            out.append(("alloc", r["ok"], r["reason"], m.version_lag()))
        elif kind == "sched":
            _, qid, plen, budget = ev
            out.append(("sched", m._schedule(qid, prompt_len=plen,
                                             new_token_budget=budget)))
        elif kind == "finish":
            m._finish_rollout(ev[1], accepted=ev[2])
        elif kind == "trained":
            nr.add(names.training_samples(m._expr, m._trial), str(ev[1]),
                   replace=True)
        elif kind == "version":
            m._model_version = ev[1]
        out.append(("state", dict(m._server_load),
                    {k: round(v, 6) for k, v in m._server_tokens.items()},
                    m.rollout_stat.running, m.rollout_stat.accepted))
    return out


def _events(seed, n=160, group=4):
    """A seeded mix of rollouts: allocations, their group members' chunked
    schedules (first chunks and continuations), finishes, the trainer's
    sample counter and weight versions.  The trainer keeps up (its counter
    follows the accepted rollouts' sequences), where the two packages'
    staleness gates count alike (see
    ``test_gate_counts_the_trainers_backlog``)."""
    rng = np.random.default_rng(seed)
    ev, live, accepted, version, k = [], [], 0, 0, 0
    for _ in range(n):
        r = rng.random()
        if r < 0.3 or not live:
            qid = f"r{k}-{rng.integers(1 << 16):x}"
            k += 1
            ev.append(("alloc", qid))
            live.append(qid)
        elif r < 0.7:
            qid = live[int(rng.integers(len(live)))]
            member = f"{qid}-{int(rng.integers(group))}"
            ev.append(("sched", member, int(rng.integers(10, 3000)),
                       int(rng.integers(16, 2048))))
        elif r < 0.9:
            qid = live.pop(int(rng.integers(len(live))))
            ok = bool(rng.random() < 0.8)
            ev.append(("finish", qid, ok))
            if ok:
                accepted += 1
                ev.append(("trained", accepted * group))
        else:
            version += 1
            ev.append(("version", version))
    return ev


@pytest.mark.parametrize(
    "policy,cfg",
    [
        ("least_requests", dict(max_head_offpolicyness=1, train_batch_size=8,
                                group_size=4, max_concurrent_rollouts=6)),
        ("round_robin", dict(max_head_offpolicyness=0, train_batch_size=8,
                             group_size=4)),
        ("least_token_usage", dict(max_head_offpolicyness=2,
                                   train_batch_size=8, group_size=4,
                                   max_concurrent_rollouts=5)),
        ("least_requests", dict(max_head_offpolicyness=1, train_batch_size=8,
                                group_size=4, cache_aware_routing=False,
                                max_concurrent_rollouts=3)),
    ],
    ids=["least_requests", "round_robin", "least_token_usage", "no_affinity"],
)
@pytest.mark.parametrize("seed", [0, 1])
def test_manager_decisions_match_the_jax_manager(policy, cfg, seed):
    ev = _events(seed)
    got = _replay("torch", ev, policy=policy, **cfg)
    want = _replay("jax", ev, policy=policy, **cfg)
    assert got == want
    kinds = {d[0] for d in want}
    assert {"alloc", "sched"} <= kinds
    allocs = [d for d in want if d[0] == "alloc"]
    assert any(d[1] for d in allocs) and any(not d[1] for d in allocs)


def test_gate_counts_the_trainers_backlog():
    """Where the trainer lags (finished rollouts wait in its stream queue,
    its loaded-sample counter unchanged), the JAX manager keeps admitting
    rollouts at the old version and they train past the bound; the port's
    gate counts every generated sequence and holds them.  Group 2, batch
    4, offpolicyness 0: two finished rollouts fill step 0's batch, so a
    third at version 0 would train at step 1."""
    gates = {}
    for pkg in PKGS:
        m = _manager(pkg, max_head_offpolicyness=0, train_batch_size=4,
                     group_size=2)
        seen = []
        for qid in ("a", "b", "c"):
            seen.append(m._allocate_rollout(qid)["ok"])
            m._finish_rollout(qid, accepted=True)
        gates[pkg] = seen
    assert gates["jax"] == [True, True, True]
    assert gates["torch"] == [True, True, False]


class _FakeServer:
    """Records the update round's calls; optionally fails its stage or its
    commit (a server-side error, as ``GenServerClient`` raises it)."""

    def __init__(self, stage_error=False, commit_error=False):
        self.calls, self.stage_error = [], stage_error
        self.commit_error = commit_error

    def call(self, cmd, payload, timeout=None):
        mode = (payload or {}).get("mode") or "full"
        self.calls.append((cmd, mode if cmd == "update_weights" else ""))
        if cmd != "update_weights":
            return "ok"
        if mode == "stage":
            if self.stage_error:
                raise RuntimeError("server error: staging failed")
            return {"staged": payload["version"], "stage_seconds": 0.01}
        if self.commit_error:
            raise RuntimeError("server error: load failed")
        return {"num_interrupted": 2}


@pytest.mark.parametrize(
    "faults",
    [{}, {"s1": dict(stage_error=True)}, {"s2": dict(commit_error=True)}],
    ids=["clean", "stage_fails", "commit_fails"],
)
def test_staged_update_order_matches_the_jax_manager(faults):
    rounds = {}
    for pkg in PKGS:
        m = _manager(pkg, update_weights_retries=1,
                     update_weights_retry_backoff_s=0.0)
        servers = {a: _FakeServer(**faults.get(a, {})) for a in m.server_addrs}
        m._clients = dict(servers)
        m._flush_and_update({"version": 3, "path": "/none", "format": "params"})
        rounds[pkg] = (m._model_version,
                       {a: s.calls for a, s in servers.items()})
    assert rounds["torch"] == rounds["jax"]
    version, calls = rounds["torch"]
    commit_failed = any(f.get("commit_error") for f in faults.values())
    assert version == (0 if commit_failed else 3)
    for a, c in calls.items():
        assert c[0][0] == "update_weights" and c[-1] == ("resume", "")


def test_exit_ends_a_swap_round_in_flight():
    """A manager that exits while a staged swap round waits on a server
    that no longer answers ends the round at once: the round's thread, in
    the update pool the interpreter joins at exit, does not wait out the
    600 s stage timeout."""
    import threading
    import time

    import zmq

    from areal_tpu_torch.system.generation_server import GenServerClient

    ctx = zmq.Context.instance()
    silent = ctx.socket(zmq.ROUTER)  # takes requests, never replies
    port = silent.bind_to_random_port("tcp://127.0.0.1")
    m = _manager("torch", staged_weight_updates=True,
                 stage_request_timeout=600.0)
    m._clients = {a: GenServerClient(f"127.0.0.1:{port}")
                  for a in m.server_addrs}
    try:
        t = threading.Thread(target=m._flush_and_update, args=(
            {"version": 1, "path": "/none", "format": "params"},), daemon=True)
        t.start()
        time.sleep(1.0)
        assert t.is_alive(), "the round should be waiting on its stage RPCs"
        tik = time.monotonic()
        m._exit_hook()
        t.join(30)
        assert not t.is_alive() and time.monotonic() - tik < 30
        assert m._model_version == 0
    finally:
        for c in m._clients.values():  # a failed check must not hang
            c.close()
        silent.close(linger=0)


class _StubManagerClient:
    def __init__(self):
        self.calls = []

    def call(self, cmd, payload):
        self.calls.append((cmd, payload))
        if cmd == "schedule_batch":
            return {"responses": [{"url": "stub:0", "version": 0}
                                  for _ in payload["qids"]]}
        return {"url": "stub:0", "version": 0}


def _stub_gen(api, per_chunk, eos_after, versions_per_token):
    class Gen:
        """Scripted server: ``per_chunk`` tokens per call, a weight swap
        between calls, EOS after ``eos_after`` tokens."""

        def __init__(self):
            self.version, self.calls = 0, []

        def generate(self, inp):
            self.calls.append((inp.qid, list(inp.input_ids),
                               inp.gconfig.max_new_tokens))
            start = len(inp.input_ids) - len(inp.prompt_ids)
            n = min(per_chunk, inp.gconfig.max_new_tokens)
            no_eos = True
            if eos_after is not None and start + n >= eos_after:
                n, no_eos = eos_after - start, False
            out = api.APIGenerateOutput(
                qid=inp.qid, prompt_ids=inp.prompt_ids,
                input_ids=inp.input_ids,
                output_ids=[100 + start + j for j in range(n)],
                output_logprobs=[-0.25 * (start + j) for j in range(n)],
                no_eos=no_eos, version_start=self.version,
                version_end=self.version)
            if versions_per_token:
                out.output_versions = [self.version] * n
            self.version += 1
            return out

        def close(self):
            pass

    return Gen()


@pytest.mark.parametrize("per_chunk,max_new,chunk,eos_after,group", [
    (4, 10, 4, None, 1), (3, 16, 3, 7, 3), (8, 8, 8, None, 2),
])
def test_partial_rollout_matches_the_jax_manager(per_chunk, max_new, chunk,
                                                 eos_after, group):
    res = {}
    for pkg, api, pr in (("jax", jmodel_api, jpr), ("torch", tmodel_api, tpr)):
        gen = _stub_gen(api, per_chunk, eos_after, pkg == "torch")
        prm = pr.PartialRolloutManager(
            _StubManagerClient(),
            api.GenerationHyperparameters(max_new_tokens=max_new),
            new_tokens_per_chunk=chunk)
        prm._server_clients["stub:0"] = gen
        outs = {}
        orig = prm._gen_one

        async def record(qid, prompt_ids, root=None, presched=None,
                         _orig=orig, _outs=outs):
            o = await _orig(qid, prompt_ids, root=root, presched=presched)
            _outs[qid] = o
            return o

        prm._gen_one = record
        b = asyncio.run(prm.generate_group("q", [1, 2, 3], group))
        res[pkg] = (b.seqs, b.logprobs, b.no_eos, b.version_start,
                    b.version_end, sorted(gen.calls),
                    [c for c, _ in prm.manager_client.calls], outs)
    assert res["torch"][:7] == res["jax"][:7]
    for qid, o in res["torch"][7].items():
        # every token's version, across the chunks' weight swaps
        assert len(o.output_versions) == len(o.output_ids)
        assert o.output_versions == sorted(o.output_versions)
        assert o.output_versions[0] == o.version_start
        assert o.output_versions[-1] == o.version_end


@pytest.fixture
def answer_env(tmp_path):
    """A word-level tokenizer whose words include right answers (the
    phase-8 tokenizer of ``chip_smoke.py`` at 64 words)."""
    import areal_tpu.agents.math_single_step_agent  # noqa: F401
    import areal_tpu.envs.math_code_single_step_env  # noqa: F401
    import areal_tpu_torch.agents.math_single_step_agent  # noqa: F401
    import areal_tpu_torch.envs.math_code_single_step_env  # noqa: F401
    import chip_smoke

    tok_dir, _ = chip_smoke.async_inputs(str(tmp_path), 64, rows=1,
                                         words=(3, 5), n_answers=4)
    return tok_dir


@pytest.mark.parametrize("lb,ub", [(0.0, 1.0), (0.1, 0.9), (0.0, 0.4)])
def test_agent_and_env_give_the_jax_packages_rewards(answer_env, lb, ub):
    """Fixed answers (words of the tokenizer, with and without a right
    boxed answer) through the agent and the environment of each package:
    the same rewards and trajectories (or the same success-rate
    filtering)."""
    from areal_tpu.api import agent_api as jagent_api
    from areal_tpu.api import env_api as jenv_api
    from areal_tpu.api.data import SequenceSample as JSample
    from areal_tpu_torch.api import agent_api as tagent_api
    from areal_tpu_torch.api import env_api as tenv_api
    from areal_tpu_torch.api.data import SequenceSample as TSample
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(answer_env)
    prompt = tok("w1 w2 w3")["input_ids"]
    texts = ["w5 \\boxed{84/2}", "w6 w7 w8", "\\boxed{42/1} w9",
             "w10", "w11 \\boxed{168/4} w12"]
    answers = [prompt + tok(t)["input_ids"] for t in texts]
    results = {}
    for pkg, agent_api, env_api, api, Sample in (
        ("jax", jagent_api, jenv_api, jmodel_api, JSample),
        ("torch", tagent_api, tenv_api, tmodel_api, TSample),
    ):
        agent = agent_api.make_agent(type(
            "A", (), {"type_": "math-single-step", "args": dict(
                gconfig=api.GenerationHyperparameters(n=len(texts)),
                success_rate_lb=lb, success_rate_ub=ub)}))
        env = env_api.make_env(type(
            "E", (), {"type_": "math-code-single-step",
                      "args": {"tokenizer_path": answer_env}}))
        sample = Sample.from_default(
            seqlens=[len(prompt)], ids=["p0"],
            data={"packed_prompts": np.asarray(prompt, np.int32)},
            metadata={"task": ["math"], "solutions": [["\\boxed{42}"]],
                      "input_output": [None], "timeout": [None]})

        async def run():
            obs, act = asyncio.Queue(), asyncio.Queue()
            task = asyncio.create_task(
                agent.collect_trajectory(sample, env, obs, act))
            qid, p, n = await obs.get()
            await act.put(api.BundledGenerationOutputs(
                qid=qid, prompt_ids=p, seqs=answers,
                logprobs=[[0.0] * (len(s) - 1) for s in answers],
                no_eos=[False] * n, version_start=[0] * n,
                version_end=[1] * n))
            return await task

        trajs = asyncio.run(run())
        results[pkg] = [
            (t.ids, {k: np.asarray(v).tolist() for k, v in t.data.items()
                     if k != "birth_time"})
            for t in trajs
        ]
    assert results["torch"] == results["jax"]
    if lb == 0.0 and ub == 1.0:
        rewards = [d["rewards"][0] for _, d in results["torch"]]
        assert 0.0 in rewards and 1.0 in rewards


def test_math_code_dataset_gives_the_jax_packages_tokens(dataset_path,
                                                        tokenizer_path):
    import areal_tpu.data.math_code_dataset  # noqa: F401
    import areal_tpu_torch.data.math_code_dataset  # noqa: F401
    from areal_tpu.api import dataset_api as jdataset_api
    from areal_tpu_torch.api import dataset_api as tdataset_api

    for rank, world in ((0, 1), (1, 3)):
        got = []
        for api in (jdataset_api, tdataset_api):
            ds = api.make_dataset(
                type("D", (), {"type_": "math_code_prompt", "args": {
                    "dataset_path": dataset_path, "max_length": 12}}),
                seed=7, dp_rank=rank, world_size=world,
                tokenizer_or_path=tokenizer_path)
            loader = api.SequenceSampleDataLoader(ds, batch_size=3,
                                                  shuffle=True, seed=7)
            got.append([(b.ids, np.asarray(b.data["packed_prompts"]).tolist(),
                         json.dumps(b.metadata, sort_keys=True))
                        for b in loader])
        assert got[0] == got[1] and got[0]
