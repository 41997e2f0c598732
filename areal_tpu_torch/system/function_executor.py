"""Per-step DFG execution on the master.

Rebuild of the reference's function-executor pair (reference:
realhf/system/function_executor.py — ``FunctionExecutor.execute_step`` :211,
``load_data`` :120; realhf/system/model_function_call.py —
``ModelFunctionCall.run`` :491 with buffer waits, dispatch, hook payloads,
reply gathering).

One asyncio task per MFC per step + one data-loading task; MFC tasks wait on
the buffer, derive a transfer plan, request every worker in the model's
group, await replies, and amend the buffer with output metadata.

The port's copy of ``areal_tpu/system/function_executor.py``,
its imports renamed to ``areal_tpu_torch``.
"""

from __future__ import annotations

import asyncio
import itertools
from typing import Any, Dict, List, Optional, Sequence

from areal_tpu_torch.api.data import SequenceSample
from areal_tpu_torch.api.dfg import (
    MFCDef,
    ModelInterfaceType,
    OffloadHook,
    ParamReallocHook,
)
from areal_tpu_torch.base import logging_, stats_tracker
from areal_tpu_torch.system.buffer import AsyncIOSequenceBuffer
from areal_tpu_torch.system.redistributor import (
    GlobalStorageTracker,
    RedistribPlanner,
)
from areal_tpu_torch.system.request_reply_stream import (
    MasterRequestReplyStream,
    NoMessage,
    Payload,
)

logger = logging_.getLogger("function_executor")


class ReplyRouter:
    """Resolves stream replies to per-request futures."""

    def __init__(self, stream: MasterRequestReplyStream):
        self.stream = stream
        self._pending: Dict[str, asyncio.Future] = {}
        self._task: Optional[asyncio.Task] = None

    def expect(self, request_id: str) -> asyncio.Future:
        fut = asyncio.get_running_loop().create_future()
        self._pending[request_id] = fut
        return fut

    async def run(self):
        while True:
            try:
                reply = self.stream.poll_reply()
            except NoMessage:
                await asyncio.sleep(0.002)
                continue
            fut = self._pending.pop(reply.request_id, None)
            if fut is None:
                logger.warning("unexpected reply %s", reply.request_id)
                continue
            data = reply.data
            if isinstance(data, dict) and "__worker_error__" in data:
                fut.set_exception(
                    RuntimeError(
                        f"worker {reply.handled_by}: {data['__worker_error__']}"
                    )
                )
            else:
                fut.set_result(reply)

    def start(self):
        self._task = asyncio.get_running_loop().create_task(self.run())

    def stop(self):
        if self._task:
            self._task.cancel()


async def group_request(
    router: ReplyRouter,
    stream: MasterRequestReplyStream,
    workers: Sequence[str],
    handle_name: str,
    data: Any = None,
    pre_hooks_per_worker: Optional[Dict[str, List[Dict]]] = None,
    post_hooks: Optional[List[Dict]] = None,
) -> Dict[str, Payload]:
    futs = {}
    for w in workers:
        p = Payload(
            handler=w,
            handle_name=handle_name,
            data=data,
            pre_hooks=(pre_hooks_per_worker or {}).get(w, []),
            post_hooks=post_hooks or [],
        )
        futs[w] = router.expect(p.request_id)
        stream.post(p)
    results = await asyncio.gather(*futs.values())
    return dict(zip(futs.keys(), results))


class FunctionExecutor:
    def __init__(
        self,
        rpcs: List[MFCDef],
        stream: MasterRequestReplyStream,
        router: ReplyRouter,
        buffer: AsyncIOSequenceBuffer,
        model_groups: Dict[str, List[str]],
        data_owner_workers: List[str],
        src_rpc_name: str,
        fetch_batch_size: int = 32,
        shuffle_dataset: bool = True,
    ):
        self.rpcs = {r.name: r for r in rpcs}
        self.stream = stream
        self.router = router
        self.buffer = buffer
        self.model_groups = model_groups
        self.data_owner_workers = data_owner_workers
        self.src_rpc_name = src_rpc_name
        self.fetch_batch_size = fetch_batch_size
        self.tracker = GlobalStorageTracker()
        self.planner = RedistribPlanner(self.tracker)
        self._fetch_cycle = itertools.cycle(data_owner_workers)
        self.epoch = 0
        self.is_new_epoch = False
        # in-process absolute trained-sample counter (single writer); read
        # lazily so the master's recovery seed lands first
        self._training_samples: Optional[int] = None

    # -- data loading -------------------------------------------------------

    async def load_data(self, n_seqs_needed: int):
        """Fetch dataset batches round-robin across DP owner workers until
        the buffer holds enough fresh sequences for the source RPC
        (reference: function_executor.py:120)."""
        src = self.rpcs[self.src_rpc_name]
        loaded = 0
        while loaded < n_seqs_needed:
            w = next(self._fetch_cycle)
            reply = (
                await group_request(
                    self.router,
                    self.stream,
                    [w],
                    "fetch",
                    data={"batch_size": self.fetch_batch_size},
                )
            )[w]
            meta: SequenceSample = reply.data["meta"]
            if reply.data["is_new_epoch"]:
                self.is_new_epoch = True
                self.epoch = max(self.epoch, reply.data["epoch"])
            self.tracker.add_data(w, meta.ids, list(meta.keys))
            await self.buffer.put_batch([meta])
            loaded += meta.bs
            self._bump_training_samples(meta.bs)

    def _bump_training_samples(self, n: int):
        """Advance the globally-trained sample counter the gserver manager's
        staleness gate reads (reference: function_executor.py:185-200); the
        master seeds it on (re)start so it survives recovery.

        The counter is owned IN-PROCESS after the first bump and published
        as an absolute value: a name_resolve read-modify-write would lose
        increments if a second writer ever appeared.  Single-writer
        assumption: exactly one FunctionExecutor
        (the master's) bumps this key; the master's recovery seed happens
        before the first bump, so reading it once here is race-free."""
        from areal_tpu_torch.base import constants, name_resolve, names

        key = names.training_samples(
            constants.experiment_name(), constants.trial_name()
        )
        if self._training_samples is None:
            try:
                self._training_samples = int(name_resolve.get(key))
            except name_resolve.NameEntryNotFoundError:
                self._training_samples = 0
        self._training_samples += n
        name_resolve.add(key, str(self._training_samples), replace=True)

    # -- one MFC ------------------------------------------------------------

    async def run_rpc(self, rpc: MFCDef) -> Dict[str, Any]:
        ids, gathered = await self.buffer.get_batch_for_rpc(
            rpc.name, rpc.input_keys, rpc.n_seqs
        )
        sample_ids = gathered.ids
        workers = self.model_groups[str(rpc.model_name)]
        plan = self.planner.derive_plan(
            workers, sample_ids, list(rpc.input_keys)
        )
        pre_hooks: Dict[str, List[Dict]] = {w: [] for w in workers}
        for w in workers:
            steps = [s for s in plan if s.dst == w]
            if steps:
                pre_hooks[w].append({"type": "data_transfer", "steps": steps})
            for hook in rpc.pre_hooks:
                pre_hooks[w].append(_hook_to_dict(hook, rpc))
        post_hooks = [_hook_to_dict(h, rpc) for h in rpc.post_hooks]

        replies = await group_request(
            self.router,
            self.stream,
            workers,
            rpc.interface_type.value,
            data={
                "rpc_name": rpc.name,
                "model_name": str(rpc.model_name),
                "handle_name": rpc.interface_type.value,
                "ids": sample_ids,
                "input_keys": list(rpc.input_keys),
                "mb_spec": rpc.mb_spec,
            },
            pre_hooks_per_worker=pre_hooks,
            post_hooks=post_hooks,
        )
        # all group workers produce identical outputs (SPMD); take the first
        lead = workers[0]
        reply = replies[lead].data
        stats: Dict[str, Any] = {}
        if "meta" in reply:
            meta: SequenceSample = reply["meta"]
            for w in workers:
                self.tracker.add_data(w, meta.ids, reply["output_keys"])
            await self.buffer.amend_batch(meta)
        if "stats" in reply and isinstance(reply["stats"], dict):
            stats = reply["stats"]
        if rpc.log_return_value:
            logger.info("MFC %s -> %s", rpc.name, stats)
        with stats_tracker.scope(rpc.name):
            elapsed = reply.get("elapsed", 0.0)
            stats_tracker.scalar(elapsed=elapsed)
            # per-MFC throughput from the worker's analytic accounting
            # (reference: realhf/system/flops_counter.py); tflops is
            # per-worker-group since every SPMD peer ran the same FLOPs
            if "flops" in reply and elapsed > 0:
                stats_tracker.scalar(
                    tflops=reply["flops"] / elapsed / 1e12,
                    tokens_per_sec=reply.get("n_tokens", 0) / elapsed,
                    n_tokens=float(reply.get("n_tokens", 0)),
                )
        return stats

    # -- one full step ------------------------------------------------------

    async def execute_step(self) -> Dict[str, Any]:
        self.is_new_epoch = False
        src = self.rpcs[self.src_rpc_name]
        tasks = [
            asyncio.ensure_future(self.load_data(src.n_seqs)),
        ]
        rpc_tasks = {
            name: asyncio.ensure_future(self.run_rpc(rpc))
            for name, rpc in self.rpcs.items()
        }
        await asyncio.gather(*tasks, *rpc_tasks.values())
        stats = {}
        for name, t in rpc_tasks.items():
            for k, v in (t.result() or {}).items():
                stats[f"{name}/{k}"] = v

        # gc: drop sequences that every terminal RPC consumed
        all_rpcs = list(self.rpcs)
        done_ids = await self.buffer.pop_consumed(all_rpcs)
        if done_ids:
            self.tracker.drop_ids(done_ids)
            await group_request(
                self.router,
                self.stream,
                list(
                    dict.fromkeys(
                        w for ws in self.model_groups.values() for w in ws
                    )
                ),
                "clear_data_cache",
                data={"ids": done_ids},
            )
        return stats


def _hook_to_dict(hook, rpc: MFCDef) -> Dict:
    if isinstance(hook, ParamReallocHook):
        src = str(hook.source or rpc.model_name)
        dst = str(hook.target or rpc.model_name)
        return {
            "type": "param_realloc",
            "source": src,
            "target": dst,
            "eta": hook.eta,
        }
    if isinstance(hook, OffloadHook):
        return {"type": "offload"}
    if isinstance(hook, dict):
        return hook
    raise ValueError(f"unknown hook {hook}")
