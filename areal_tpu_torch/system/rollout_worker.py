"""Rollout worker: drives agent/env loops against the generation cluster.

Rebuild of the reference's rollout worker (reference:
realhf/system/rollout_worker.py — ``_poll_async`` :204 loading one prompt per
poll, ``/allocate_rollout`` gating :188, ``agent.collect_trajectory`` tasks
with obs/act queues driving the PartialRolloutManager, trajectory push via
ZMQ :293, ``/finish_rollout`` :304).

The port's copy of ``areal_tpu/system/rollout_worker.py``,
its imports renamed to ``areal_tpu_torch``.  One difference: the manager
calls (allocate and finish) run on a thread pool of their own, not on
the event loop's default one, where they would queue behind the group
members' generate calls; so a poll, and the commands read between polls
(the launcher's ``exit``), never wait for a generate chunk.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import itertools
from typing import Dict, List, Optional, Set

from areal_tpu_torch.api import agent_api, dataset_api, env_api, system_api
from areal_tpu_torch.base import constants, logging_
from areal_tpu_torch.system import worker_base
from areal_tpu_torch.system.gserver_manager import GserverManagerClient
from areal_tpu_torch.system.partial_rollout import PartialRolloutManager
from areal_tpu_torch.system.push_pull_stream import NameResolvingZmqPusher

logger = logging_.getLogger("rollout_worker")


class RolloutWorker(worker_base.AsyncWorker):
    def _configure(self, config: system_api.RolloutWorkerConfig):
        self.config = config
        self.worker_name = config.worker_name
        self.logger = logging_.getLogger(self.worker_name)

        self._expr = constants.experiment_name()
        self._trial = constants.trial_name()

        self.agent = agent_api.make_agent(config.agent)
        self.env = env_api.make_env(config.env)

        tokenizer = (
            dataset_api.load_hf_tokenizer(config.tokenizer_path)
            if config.tokenizer_path
            else None
        )
        dp_rank, dp_size = config.dataset_shard
        datasets = [
            dataset_api.make_dataset(
                d,
                seed=config.dataset_seed,
                dp_rank=dp_rank,
                world_size=dp_size,
                tokenizer_or_path=tokenizer,
            )
            for d in config.datasets
        ]
        self._dataset = datasets[0]
        self._data_iter = itertools.cycle(range(len(self._dataset)))

        self.manager_client = GserverManagerClient(self._expr, self._trial)
        self._manager_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=2, thread_name_prefix=f"{self.worker_name}-manager")
        self.prm = PartialRolloutManager(
            self.manager_client,
            config.gconfig,
            new_tokens_per_chunk=config.new_tokens_per_chunk,
            request_timeout=config.rollout_request_timeout,
            workload=getattr(config, "workload", "rollout"),
            batch_schedule=getattr(config, "batch_schedule", True),
        )
        self.pusher = NameResolvingZmqPusher(
            self._expr, self._trial, pusher_index=dp_rank
        )
        self._tasks: Set[asyncio.Task] = set()
        self._gen_tasks: Set[asyncio.Task] = set()
        self.rollout_count = 0
        self.push_count = 0
        self._alloc_counter = 0

        from areal_tpu_torch.observability import get_registry
        from areal_tpu_torch.observability import tracing

        reg = get_registry()
        self._m_episodes = reg.counter("areal_rollout_episodes_total")
        self._m_pushed = reg.counter("areal_rollout_pushed_total")
        self._m_rejected = reg.counter("areal_rollout_alloc_rejected_total")
        # flight recorder: this worker opens each sampled rollout's
        # episode span; the PartialRolloutManager below traces the
        # per-member generation path under the same trace root (the
        # rollout qid)
        self._tracer = tracing.configure(config.trace, worker=self.worker_name)

    async def _rollout_task(self, qid: str, prompt_sample):
        obs_q: asyncio.Queue = asyncio.Queue()
        act_q: asyncio.Queue = asyncio.Queue()

        async def gen_pump():
            # loop: multi-turn agents issue one obs per turn (reference:
            # math_multi_turn_agent.py); cancelled when the agent returns
            while True:
                q, prompt_ids, group_size = await obs_q.get()
                bundle = await self.prm.generate_group(
                    q, prompt_ids, group_size
                )
                await act_q.put(bundle)

        pump = asyncio.create_task(gen_pump())
        self._gen_tasks.add(pump)
        pump.add_done_callback(self._gen_tasks.discard)
        accepted = False
        pushed = 0
        self._tracer.span_begin(qid, "rollout.episode", root=qid)
        agent_task = asyncio.create_task(
            self.agent.collect_trajectory(prompt_sample, self.env, obs_q, act_q)
        )
        try:
            # wait on BOTH: a pump failure must surface instead of leaving
            # the agent blocked on act_q forever (slot would never release)
            await asyncio.wait(
                {agent_task, pump}, return_when=asyncio.FIRST_COMPLETED
            )
            if not agent_task.done():
                agent_task.cancel()
                try:
                    await agent_task
                except asyncio.CancelledError:
                    pass
                pump.result()  # raises the pump's exception
            trajs = await agent_task
            accepted = len(trajs) > 0
            if accepted:
                self.pusher.push([t.as_json_compatible() for t in trajs])
                self.push_count += len(trajs)
                pushed = len(trajs)
                self._m_pushed.inc(len(trajs))
        finally:
            if not pump.done():
                pump.cancel()
            # always release the manager's rollout slot; on exit the
            # client is aborted and the slot dies with the manager
            try:
                await self._manager_call(
                    "finish_rollout", {"qid": qid, "accepted": accepted})
            except (TimeoutError, ConnectionError, OSError):
                if not self.exit_requested:
                    raise
            self.rollout_count += 1
            self._m_episodes.inc()
            self._tracer.span_end(
                qid, "rollout.episode", root=qid,
                accepted=accepted, pushed=pushed,
            )

    async def _manager_call(self, cmd: str, payload: Dict):
        # a worker built without _configure (tests) has no pool: the
        # loop's default one serves
        try:
            fut = asyncio.get_running_loop().run_in_executor(
                getattr(self, "_manager_pool", None),
                self.manager_client.call, cmd, payload)
        except RuntimeError as e:
            # the exit hook shut the pool down and the loop's shutdown is
            # cancelling the rollouts: as with the aborted client, the
            # slot dies with the manager
            raise ConnectionError(f"{cmd}: the manager calls' pool is shut "
                                  "down") from e
        return await fut

    async def _poll_async(self) -> worker_base.PollResult:
        # harvest finished tasks (exceptions propagate)
        done = [t for t in self._tasks if t.done()]
        for t in done:
            self._tasks.discard(t)
            t.result()

        idx = next(self._data_iter)
        prompt_sample = self._dataset[idx]
        # unique rollout id: the same prompt may roll out repeatedly across
        # epochs, and trajectory ids derive from it (buffer ids must be
        # unique; reference tracks used ids, rollout_worker.py:181)
        qid = f"{prompt_sample.ids[0]}#{self.config.dataset_shard[0]}-{self._alloc_counter}"
        self._alloc_counter += 1
        prompt_sample.ids = [qid]
        try:
            resp = await self._manager_call("allocate_rollout", {"qid": qid})
        except (TimeoutError, ConnectionError, OSError):
            if self.exit_requested:
                # exit() aborted the client mid-call so this loop could
                # observe the flag at all — not a failure
                return worker_base.PollResult(sample_count=0)
            raise
        if not resp["ok"]:
            self._m_rejected.inc(reason=resp.get("reason") or "unknown")
            self._tracer.event(
                qid, "rollout.alloc_reject", root=qid,
                reason=resp.get("reason") or "unknown",
            )
            await asyncio.sleep(0.05)
            return worker_base.PollResult(sample_count=0)
        task = asyncio.create_task(self._rollout_task(qid, prompt_sample))
        self._tasks.add(task)
        return worker_base.PollResult(sample_count=1)

    def exit(self, status=worker_base.WorkerServerStatus.COMPLETED):
        """Abort in-flight RPC clients at exit-REQUEST time, not exit-hook
        time: the poll loop itself may be parked inside a client call
        (allocate_rollout to a gone manager: 60s; a generate to a gone
        server: up to rollout_request_timeout), and it can only observe
        the exit flag once that call returns.  Un-aborted, the worker
        thread lingers for the full RPC timeout after the experiment
        ends, and ``concurrent.futures``' atexit hook then joins the
        executor threads those calls run on — the e2e teardown used to
        pay up to ~600 s of interpreter-shutdown linger for this."""
        super().exit(status)
        if hasattr(self, "manager_client"):
            self.manager_client.close()
        if hasattr(self, "prm"):
            self.prm.close()

    def _exit_hook(self):
        if hasattr(self, "prm"):
            self.prm.close()
        if hasattr(self, "manager_client"):
            # unblocks executor threads parked in manager calls; without
            # this asyncio.run's shutdown joins them for up to 300s
            self.manager_client.close()
        if hasattr(self, "pusher"):
            self.pusher.close()
        if hasattr(self, "_manager_pool"):
            self._manager_pool.shutdown(wait=False)
