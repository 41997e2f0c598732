"""Master worker: walks the MFC graph, controls save/eval/recover.

Rebuild of the reference's master (reference: realhf/system/master_worker.py
— ``_configure`` :52, lazy init :251 building streams + initializing
backends, ``__poll_async`` :381 running ``FunctionExecutor.execute_step``,
save/eval/ckpt frequency control, recover save :585, benchmark early exit
:455).

The port's copy of ``areal_tpu/system/master_worker.py``,
its imports renamed to ``areal_tpu_torch``.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Dict, Optional

from areal_tpu_torch.api import model_api, system_api
from areal_tpu_torch.api.dfg import ModelInterfaceType
from areal_tpu_torch.base import (
    constants,
    logging_,
    name_resolve,
    names,
    recover,
    seeding,
    stats_tracker,
    timeutil,
)
from areal_tpu_torch.system import worker_base
from areal_tpu_torch.system.buffer import AsyncIOSequenceBuffer
from areal_tpu_torch.system.function_executor import (
    FunctionExecutor,
    ReplyRouter,
    group_request,
)
from areal_tpu_torch.system.request_reply_stream import MasterRequestReplyStream

logger = logging_.getLogger("master_worker")


class MasterWorker(worker_base.AsyncWorker):
    def _configure(self, config: system_api.MasterWorkerConfig):
        self.config = config
        self.worker_name = config.worker_name
        self.logger = logging_.getLogger(self.worker_name)
        seeding.set_random_seed(config.seed, "master")

        self._initialized = False
        self._step_info = recover.StepInfo()
        self._ft_spec: Optional[model_api.FinetuneSpec] = None
        self._start_time = time.monotonic()

        ctrl = config.exp_ctrl
        self._save_ctl = timeutil.EpochStepTimeFreqCtl(
            freq_epoch=ctrl.save_freq_epochs,
            freq_step=ctrl.save_freq_steps,
            freq_sec=ctrl.save_freq_secs,
        )
        self._ckpt_ctl = timeutil.EpochStepTimeFreqCtl(
            freq_epoch=ctrl.ckpt_freq_epochs,
            freq_step=ctrl.ckpt_freq_steps,
            freq_sec=ctrl.ckpt_freq_secs,
        )
        self._eval_ctl = timeutil.EpochStepTimeFreqCtl(
            freq_epoch=ctrl.eval_freq_epochs,
            freq_step=ctrl.eval_freq_steps,
            freq_sec=ctrl.eval_freq_secs,
        )
        self.stats: Dict[str, Any] = {}
        self.stats_history = []
        from areal_tpu_torch.base.metrics import MetricsLogger
        from areal_tpu_torch.base.monitor import UtilizationMonitor

        self._metrics = MetricsLogger(
            constants.get_log_path(),
            experiment_name=constants.experiment_name(),
            trial_name=constants.trial_name(),
        )
        # host sampler (reference: the gpu_utilization_monitor thread,
        # realhf/base/monitor.py:266); the device gauges come from the
        # processes that hold the card, so the master never creates a CUDA
        # context of its own
        self._util_monitor = UtilizationMonitor()
        self._util_monitor.start()

        # cluster-wide scrape aggregator: discovers every worker's /metrics
        # endpoint via name_resolve, snapshots to jsonl each step, and feeds
        # the MetricsLogger sinks (reference: the controller-bound metric
        # servers, realhf/system/controller.py:41-74 — ours pulls instead)
        import os as _os

        from areal_tpu_torch.observability import get_registry
        from areal_tpu_torch.observability.aggregator import (
            ClusterMetricsAggregator,
        )

        self._m_step_s = get_registry().histogram("areal_master_step_seconds")
        self._cluster_agg = ClusterMetricsAggregator(
            constants.experiment_name(),
            constants.trial_name(),
            snapshot_path=_os.path.join(
                constants.get_log_path(), "cluster_metrics.jsonl"
            ),
        )
        # flight recorder: the master owns the trace collector — one
        # harvest cycle per train step over the same discovery plane as
        # the metrics scrape, writing traces.jsonl (+ a Perfetto export
        # at close) and running the stall watchdog
        from areal_tpu_torch.observability import tracing
        from areal_tpu_torch.observability.trace_collector import TraceCollector

        tracing.configure(config.trace, worker=config.worker_name)
        self._trace_collector = TraceCollector(
            constants.experiment_name(),
            constants.trial_name(),
            out_dir=constants.get_log_path(),
            config=config.trace,
        )

    async def _lazy_init(self):
        cfg = self.config
        self._stream = MasterRequestReplyStream(
            constants.experiment_name(), constants.trial_name()
        )
        self._stream.connect(cfg.model_worker_names)
        self._router = ReplyRouter(self._stream)
        self._router.start()

        # dataset spec -> FinetuneSpec
        data_workers = self._data_owner_workers()
        specs = await group_request(
            self._router, self._stream, data_workers, "spec"
        )
        dataset_size = sum(r.data["dataset_size"] for r in specs.values())
        train_rpc = next(
            r for r in cfg.model_rpcs if r.name == cfg.train_rpc_name
        )
        self._ft_spec = model_api.FinetuneSpec(
            total_train_epochs=cfg.exp_ctrl.total_train_epochs,
            dataset_size=max(dataset_size, train_rpc.n_seqs),
            train_batch_size=train_rpc.n_seqs,
        )

        # initialize all model shards everywhere
        await group_request(
            self._router,
            self._stream,
            cfg.model_worker_names,
            "initialize_all",
            data={"ft_spec": self._ft_spec},
        )

        self._buffer = AsyncIOSequenceBuffer()
        src_rpcs = [r for r in cfg.model_rpcs if r.is_src]
        self._executor = FunctionExecutor(
            rpcs=cfg.model_rpcs,
            stream=self._stream,
            router=self._router,
            buffer=self._buffer,
            model_groups=cfg.model_groups,
            data_owner_workers=data_workers,
            src_rpc_name=src_rpcs[0].name,
            fetch_batch_size=max(
                1, src_rpcs[0].n_seqs // max(1, len(data_workers))
            ),
        )

        # recover? gated on the same flag the workers use for weight reload
        # (apps/main.py sets it on restart attempts) so master StepInfo and
        # worker weights can never silently diverge: without the flag a
        # stale recover_info.json from an earlier trial is ignored
        import os

        info = (
            recover.discover() if os.environ.get("AREAL_RECOVER") == "1" else None
        )
        if info is not None:
            self._step_info = info.recover_start
            self._save_ctl.load_state_dict(info.save_ctl_states)
            self._eval_ctl.load_state_dict(info.eval_ctl_states)
            self._ckpt_ctl.load_state_dict(info.ckpt_ctl_states)
            self.logger.info(
                "recovered at step %s", self._step_info
            )
        # seed the globally-trained sample counter the staleness gate reads:
        # fresh start -> 0, recover -> batch * completed steps, so the gate
        # never loosens after a restart (reference: master_worker.py:148-158)
        train_rpcs = [
            r
            for r in self.config.model_rpcs
            if r.interface_type == ModelInterfaceType.TRAIN_STEP
        ]
        if train_rpcs:
            hist = train_rpcs[0].n_seqs * self._step_info.global_step
            name_resolve.add(
                names.training_samples(
                    constants.experiment_name(), constants.trial_name()
                ),
                str(hist),
                replace=True,
            )
        self._initialized = True
        self.logger.info(
            "master initialized: dataset_size=%d steps/epoch=%d total=%d",
            dataset_size,
            self._ft_spec.steps_per_epoch,
            self._ft_spec.total_train_steps,
        )

    def _data_owner_workers(self):
        return [w for w in self.config.model_worker_names]

    def _train_models(self):
        return sorted(
            {
                str(r.model_name)
                for r in self.config.model_rpcs
                if r.interface_type == ModelInterfaceType.TRAIN_STEP
            }
        )

    async def _save_models(self, tag: str):
        """``save`` = persistent HF-format export (one worker host-gathers);
        ``ckpt`` = recover checkpoint — sharded train state written by EVERY
        SPMD peer of the group into the recover dir (reference: the save- vs
        ckpt-frequency split of ExperimentSaveEvalControl, cli_args.py:702,
        and the recover save realhf/system/model_worker.py:1159-1245)."""
        import os

        for mname in self._train_models():
            workers = self.config.model_groups[mname]
            if tag == "ckpt":
                path = os.path.join(
                    constants.get_recover_path(),
                    mname,
                    f"globalstep{self._step_info.global_step}",
                )
                await group_request(
                    self._router,
                    self._stream,
                    workers,
                    "ckpt",
                    data={"model_name": mname, "path": path},
                )
                self._prune_recover_ckpts(mname, keep=2)
            else:
                path = os.path.join(
                    constants.get_save_path(),
                    mname,
                    f"epoch{self._step_info.epoch}"
                    f"epochstep{self._step_info.epoch_step}"
                    f"globalstep{self._step_info.global_step}",
                )
                await group_request(
                    self._router,
                    self._stream,
                    workers[:1],
                    "save",
                    data={"model_name": mname, "path": path},
                )
            self.logger.info("saved %s (%s) -> %s", mname, tag, path)

    def _prune_recover_ckpts(self, mname: str, keep: int = 2):
        """Drop recover checkpoints older than the newest ``keep`` — they are
        full sharded train states (params + optimizer), so an unbounded run
        would otherwise grow disk without limit (the publish path already
        GCs this way; recover checkpoints must too)."""
        import os
        import re
        import shutil

        root = os.path.join(constants.get_recover_path(), mname)
        try:
            dirs = [
                (int(m.group(1)), d)
                for d in os.listdir(root)
                if (m := re.fullmatch(r"globalstep(\d+)", d))
            ]
        except FileNotFoundError:
            return
        for _, d in sorted(dirs)[:-keep]:
            shutil.rmtree(os.path.join(root, d), ignore_errors=True)
            self.logger.info("pruned old recover ckpt %s/%s", mname, d)

    def _recover_save(self):
        # _step_info counts COMPLETED steps (incremented after each step),
        # so the resume point IS the current value — the poll loop's own
        # increment advances it when the next step completes
        info = recover.RecoverInfo(
            recover_start=self._step_info,
            last_step_info=self._step_info,
            save_ctl_states=self._save_ctl.state_dict(),
            eval_ctl_states=self._eval_ctl.state_dict(),
            ckpt_ctl_states=self._ckpt_ctl.state_dict(),
        )
        recover.dump(info)

    async def _poll_async(self) -> worker_base.PollResult:
        if not self._initialized:
            await self._lazy_init()

        tik = time.monotonic()
        stats = await self._executor.execute_step()
        elapsed = time.monotonic() - tik

        epochs_passed = 1 if self._executor.is_new_epoch else 0
        self._step_info = self._step_info.next(self._ft_spec.steps_per_epoch)
        step = self._step_info

        stats["time_perf/e2e"] = elapsed
        # master-side per-MFC tracking (elapsed / tflops / tok_s recorded by
        # the executor) joins the worker-reported interface stats
        stats.update(stats_tracker.export())
        stats.update(self._util_monitor.export())
        self.stats = stats
        self.stats_history.append(stats)
        # observability plane: master step time + scoped stats become
        # scrapeable BEFORE the cluster scrape (so the master's own page is
        # fresh), then the cluster snapshot merges into THIS step's sink
        # row — one jsonl row per step, cluster/* keys alongside the stats
        self._m_step_s.observe(elapsed)
        from areal_tpu_torch.observability import get_registry

        get_registry().set_stats(
            {
                k: v
                for k, v in stats.items()
                if isinstance(v, (int, float)) and not isinstance(v, bool)
            }
        )
        cluster = {}
        try:
            cluster = self._cluster_agg.step(step.global_step)
        except Exception:  # noqa: BLE001 - scraping never fails a step
            self.logger.exception("cluster metrics scrape failed")
        try:
            # the cluster row carries the fleet-merged SLO percentiles;
            # handing it to the collector arms the p99-TTFT alarm
            self._trace_collector.step(step.global_step, fleet_slo=cluster)
        except Exception:  # noqa: BLE001 - tracing never fails a step
            self.logger.exception("trace harvest failed")
        self._metrics.log({**stats, **cluster}, step.global_step)
        self.logger.info(
            "step %d (epoch %d, %.2fs): %s",
            step.global_step,
            step.epoch,
            elapsed,
            {k: round(v, 4) for k, v in stats.items() if isinstance(v, float)},
        )

        if self._eval_ctl.check(epochs=epochs_passed, steps=1):
            await self._run_eval()
        if self._save_ctl.check(epochs=epochs_passed, steps=1):
            await self._save_models("save")
        if self._ckpt_ctl.check(epochs=epochs_passed, steps=1):
            await self._save_models("ckpt")
            self._recover_save()

        bench = self.config.exp_ctrl.benchmark_steps
        done = step.global_step >= self._ft_spec.total_train_steps or (
            bench is not None and step.global_step >= bench
        )
        if done:
            self.logger.info(
                "training complete at step %d (%.1fs total)",
                step.global_step,
                time.monotonic() - self._start_time,
            )
            self.exit()
        return worker_base.PollResult(batch_count=1)

    async def _run_eval(self):
        evals = [
            r
            for r in self.config.model_rpcs
            if r.interface_type == ModelInterfaceType.EVALUATE
        ]
        for rpc in evals:
            workers = self.config.model_groups[str(rpc.model_name)]
            replies = await group_request(
                self._router,
                self._stream,
                workers[:1],
                "evaluate",
                data={
                    "rpc_name": rpc.name,
                    "model_name": str(rpc.model_name),
                    "handle_name": "evaluate",
                    "ids": [],
                    "input_keys": [],
                    "mb_spec": rpc.mb_spec,
                },
            )
            self.logger.info(
                "eval %s -> %s", rpc.name, replies[workers[0]].data
            )

    def _exit_hook(self):
        if hasattr(self, "_router"):
            self._router.stop()
        if hasattr(self, "_stream"):
            self._stream.close()
        if hasattr(self, "_metrics"):
            self._metrics.close()
        if hasattr(self, "_util_monitor"):
            self._util_monitor.stop()
        if hasattr(self, "_cluster_agg"):
            self._cluster_agg.close()
        if hasattr(self, "_trace_collector"):
            # final harvest so the tail of the run is in traces.jsonl,
            # then close (which writes the Perfetto export)
            try:
                self._trace_collector.step(self._step_info.global_step)
            except Exception:  # noqa: BLE001 - best-effort tail harvest
                pass
            self._trace_collector.close()
