"""Automatic evaluator: watch the checkpoint dir, eval each new save (port
of ``areal_tpu/scheduler/evaluator.py``).

It discovers ``epoch{X}epochstep{Y}globalstep{Z}`` checkpoint dirs as they
appear, submits one offline eval job per checkpoint (at most one running)
running the port's eval CLI (``areal_tpu_torch/apps/eval.py``) **through
the scheduler client layer** (``scheduler/client.py``: a local subprocess
or slurm), parses the result JSON, and logs scores keyed by global step
through the shared MetricsLogger.

The eval job's device (:func:`resolve_eval_env`) is a card unless the
config says ``"cpu"``: a spare local card when the workers leave one,
else the card the workers use, shared with them (one card holds a
trainer, servers and the job at once), pinned with
``CUDA_VISIBLE_DEVICES``.  The decision reads the device count without
creating a CUDA context in the controller.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import re
import sys
import time
from typing import Dict, List, Optional

from areal_tpu_torch.base import logging_
from areal_tpu_torch.scheduler.client import (
    JobInfo,
    JobState,
    LocalSchedulerClient,
    SchedulerClient,
    make_scheduler,
)

logger = logging_.getLogger("evaluator")

CKPT_DIR_RE = re.compile(r"epoch(\d+)epochstep(\d+)globalstep(\d+)")


class EvalStatus(enum.Enum):
    PENDING = 0
    RUNNING = 1
    DONE = 2
    FAILED = 3


@dataclasses.dataclass
class EvaluationStep:
    global_step: int
    ckpt_dir: str
    output_path: str
    status: EvalStatus = EvalStatus.PENDING
    #: worker_type the job was submitted under (scheduler job lookup key)
    job_key: Optional[str] = None
    #: the parsed result JSON once harvested
    result: Optional[Dict] = None

    @classmethod
    def from_ckpt_dir(cls, ckpt_dir: str, output_root: str):
        m = CKPT_DIR_RE.fullmatch(os.path.basename(ckpt_dir))
        if m is None:
            return None
        step = int(m.group(3))
        return cls(
            global_step=step,
            ckpt_dir=ckpt_dir,
            output_path=os.path.join(
                output_root, f"globalstep{step}", "eval_result.json"
            ),
        )


class AutomaticEvaluator:
    """Poll-driven: call :meth:`step` periodically (the launcher's monitor
    loop or a dedicated thread)."""

    def __init__(
        self,
        ckpt_root: str,
        dataset_path: str,
        output_root: str,
        metrics=None,
        max_prompts: int = 64,
        max_new_tokens: int = 256,
        env: Optional[Dict[str, str]] = None,
        eval_argv=None,  # (EvaluationStep) -> argv; test seam
        scheduler: Optional[SchedulerClient] = None,
        device: Optional[str] = None,
    ):
        self._eval_argv = eval_argv or self._default_argv
        self.ckpt_root = ckpt_root
        self.dataset_path = dataset_path
        self.output_root = output_root
        self.metrics = metrics
        self.max_prompts = max_prompts
        self.max_new_tokens = max_new_tokens
        self._env = env
        # the eval CLI's --device (None: its default, the card)
        self.device = device
        # jobs go through the scheduler layer so a cluster deployment gives
        # evals their own resources (slurm) while a dev box keeps the local
        # subprocess behavior (reference: the dedicated eval partition)
        self._sched = scheduler or LocalSchedulerClient(
            "evaluator", "auto", env=env
        )
        self._steps: Dict[int, EvaluationStep] = {}
        # resume: outputs that already exist are LOGGED equivalents
        if os.path.isdir(output_root):
            for d in os.listdir(output_root):
                m = re.fullmatch(r"globalstep(\d+)", d)
                p = os.path.join(output_root, d, "eval_result.json")
                if m and os.path.isfile(p):
                    step = int(m.group(1))
                    self._steps[step] = EvaluationStep(
                        step, "", p, status=EvalStatus.DONE
                    )

    def _default_argv(self, step: "EvaluationStep") -> List[str]:
        return [
            sys.executable,
            "-m",
            "areal_tpu_torch.apps.eval",
            "--ckpt",
            step.ckpt_dir,
            "--dataset",
            self.dataset_path,
            "--output",
            step.output_path,
            "--max-prompts",
            str(self.max_prompts),
            "--max-new-tokens",
            str(self.max_new_tokens),
        ] + (["--device", self.device] if self.device else [])

    def _discover(self):
        if not os.path.isdir(self.ckpt_root):
            return
        for d in sorted(os.listdir(self.ckpt_root)):
            full = os.path.join(self.ckpt_root, d)
            if not os.path.isdir(full):
                continue
            step = EvaluationStep.from_ckpt_dir(full, self.output_root)
            if step is not None and step.global_step not in self._steps:
                self._steps[step.global_step] = step
                logger.info(
                    "discovered checkpoint for eval: globalstep%d",
                    step.global_step,
                )

    def _maybe_submit(self):
        if any(s.status == EvalStatus.RUNNING for s in self._steps.values()):
            return  # at most one eval at a time (reference behavior)
        pending = sorted(
            (s for s in self._steps.values() if s.status == EvalStatus.PENDING),
            key=lambda s: s.global_step,
        )
        if not pending:
            return
        step = pending[0]
        os.makedirs(os.path.dirname(step.output_path), exist_ok=True)
        log_path = os.path.join(
            os.path.dirname(step.output_path), "output.log"
        )
        step.job_key = f"eval_gs{step.global_step}"
        self._sched.submit(
            step.job_key,
            self._eval_argv(step),
            env=self._env,
            log_path=log_path,
        )
        step.status = EvalStatus.RUNNING
        logger.info("submitted eval for globalstep%d", step.global_step)

    def _find_job(self, step: EvaluationStep) -> Optional[JobInfo]:
        """The scheduler job of a RUNNING step.  Local clients name jobs
        ``{worker_type}/{idx}``, slurm uses the bare worker_type — match
        both."""
        for job in self._sched.find_all():
            if job.name == step.job_key or job.name.startswith(
                step.job_key + "/"
            ):
                return job
        return None

    def _harvest(self):
        for step in self._steps.values():
            if step.status != EvalStatus.RUNNING:
                continue
            job = self._find_job(step)
            if job is None or job.state in (
                JobState.PENDING,
                JobState.RUNNING,
            ):
                continue
            if job.state != JobState.COMPLETED or not os.path.isfile(
                step.output_path
            ):
                step.status = EvalStatus.FAILED
                logger.warning(
                    "eval for globalstep%d failed (job %s: %s)",
                    step.global_step,
                    job.name,
                    job.state.value,
                )
                continue
            try:
                with open(step.output_path) as f:
                    result = json.load(f)
            except json.JSONDecodeError:
                step.status = EvalStatus.FAILED
                continue
            step.status = EvalStatus.DONE
            scores = {"eval/accuracy": result.get("accuracy", 0.0)}
            for t, d in result.get("per_task", {}).items():
                scores[f"eval/{t}_accuracy"] = d["accuracy"]
            step.result = result
            if self.metrics is not None:
                self.metrics.log(scores, step.global_step)
            logger.info(
                "eval globalstep%d: %s", step.global_step, scores
            )

    def step(self):
        self._discover()
        self._harvest()
        self._maybe_submit()

    @property
    def results(self) -> Dict[int, str]:
        return {
            s.global_step: s.output_path
            for s in self._steps.values()
            if s.status == EvalStatus.DONE
        }

    def shutdown(self):
        self._sched.stop_all()


def _claimed_devices(cfg) -> int:
    """Local cards the experiment's workers occupy (model workers from
    card 0; generation servers at their ``device_idx``)."""
    n = 0
    for w in getattr(cfg, "model_workers", []) or []:
        for s in w.shards:
            n = max(n, int(getattr(s.mesh_spec, "world_size", 1)))
    for g in getattr(cfg, "gen_servers", []) or []:
        world = int(getattr(g.mesh_spec, "world_size", 1) or 1)
        if g.device_idx is not None:
            n = max(n, g.device_idx + world)
        else:
            n = max(n, world)
    return n


def local_card_count() -> int:
    """The number of CUDA devices this process sees, read without creating
    a CUDA context (``torch.cuda.device_count`` leaves
    ``torch.cuda.is_initialized()`` False): the controller must not hold
    the card its workers use."""
    import torch

    return int(torch.cuda.device_count())


def resolve_eval_env(cfg, device: str):
    """``(env, device)`` of the eval subprocess for
    ``EvaluatorConfig.device``, ``device`` being the eval CLI's
    ``--device`` (None: its default, the card):

    * ``"auto"`` (default): a card, pinned with ``CUDA_VISIBLE_DEVICES``:
      the last card when the workers leave it spare, else the last of the
      workers' cards, shared with them.  No card is an error: the CPU is
      used only when asked for.
    * ``"cpu"``: the CPU, with every card hidden from the job.
    * ``""``: inherit this process's environment.
    * another torch device string (``"cuda:1"``): passed as it is.
    """
    if device == "auto":
        n_dev = local_card_count()
        if n_dev < 1:
            raise RuntimeError(
                "evaluator device 'auto' needs a CUDA device and none is "
                "visible; set EvaluatorConfig.device='cpu' to evaluate on "
                "the CPU"
            )
        claimed = _claimed_devices(cfg)
        idx = n_dev - 1
        visible = [
            d for d in os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")
            if d.strip()
        ]
        pin = visible[idx] if idx < len(visible) else str(idx)
        env = {**os.environ, "CUDA_VISIBLE_DEVICES": pin}
        if claimed < n_dev:
            logger.info(
                "evaluator: %d/%d local cards claimed by workers; eval jobs "
                "run on the spare card %s", claimed, n_dev, pin,
            )
        else:
            logger.info(
                "evaluator: all %d local cards claimed by workers; eval "
                "jobs share card %s with them", n_dev, pin,
            )
        return env, None
    if device == "cpu":
        logger.info("evaluator: eval jobs run on the CPU (configured)")
        return {**os.environ, "CUDA_VISIBLE_DEVICES": ""}, "cpu"
    if device:
        return dict(os.environ), device
    return dict(os.environ), None


def make_evaluator(
    cfg, scheduler_mode: str = "local", **scheduler_kwargs
) -> Optional[AutomaticEvaluator]:
    """Build the checkpoint-watching evaluator for an ExperimentConfig
    (None when the experiment configures none).  Shared by the process
    launcher's monitor loop and the threaded local runner; the eval
    subprocess device policy is :func:`resolve_eval_env` and jobs are
    submitted through ``make_scheduler(scheduler_mode, ...)`` — "slurm"
    gives evals their own cluster allocation."""
    if getattr(cfg, "evaluator", None) is None:
        return None
    from areal_tpu_torch.base import constants
    from areal_tpu_torch.base.metrics import MetricsLogger

    ecfg = cfg.evaluator
    if scheduler_mode == "local":
        env, device = resolve_eval_env(cfg, ecfg.device)
    elif ecfg.device and ecfg.device != "auto":
        # an explicit device holds on remote allocations too
        env, device = resolve_eval_env(cfg, ecfg.device)
    else:
        # a remote allocation (slurm) gets its own node: the controller
        # host's card policy means nothing there; the job takes its card
        env, device = dict(os.environ), None
    # the scheduler client only needs the DELTA vs the submitting process's
    # environment: local subprocesses inherit the rest, and sbatch exports
    # the submission env by default — handing slurm the full os.environ
    # would write every var (incl. exported bash functions) as repr()'d
    # `export` lines into the sbatch script and corrupt it
    env_delta = {
        k: v for k, v in env.items() if os.environ.get(k) != v
    }
    # the master saves each model under str(ModelName), "<role>@<replica>"
    # (system/master_worker.py _save_models): a bare role names replica 0.
    # The reference joins the bare name and never finds a save
    model_dir = (ecfg.model_name if "@" in ecfg.model_name
                 else f"{ecfg.model_name}@0")
    return AutomaticEvaluator(
        ckpt_root=os.path.join(constants.get_save_path(), model_dir),
        dataset_path=ecfg.dataset_path,
        output_root=os.path.join(constants.get_log_path(), "eval"),
        metrics=MetricsLogger(
            os.path.join(constants.get_log_path(), "eval"),
            experiment_name=cfg.experiment_name,
            trial_name=cfg.trial_name,
        ),
        max_prompts=ecfg.max_prompts,
        max_new_tokens=ecfg.max_new_tokens,
        env=env,
        device=device,
        scheduler=make_scheduler(
            scheduler_mode,
            cfg.experiment_name,
            f"{cfg.trial_name}-eval",
            env=env_delta,
            **scheduler_kwargs,
        ),
    )


def run_evaluator_loop(
    evaluator: AutomaticEvaluator,
    stop_event,
    interval: float = 5.0,
):
    """Drive an evaluator until ``stop_event`` is set, then drain."""
    while not stop_event.wait(interval):
        evaluator.step()
    # final sweep: harvest anything that finished, but don't start new jobs
    evaluator._discover()
    evaluator._harvest()
    evaluator.shutdown()
