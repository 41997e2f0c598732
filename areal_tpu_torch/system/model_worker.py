"""Model worker: hosts model engines and a dataset shard, executes MFCs
(port of ``areal_tpu/system/model_worker.py``).

One model worker drives one device (``ModelWorkerConfig.device``: None =
``cuda``, or ``"cpu"`` when the caller asks for it) for every model role
assigned to it.  What differs from the JAX package:

* engines are the port's one-device ``TrainEngine`` (meshes of more than
  one device are refused, ROADMAP.md queue 1, item 10), with float32
  master weights drawn by :func:`areal_tpu_torch.engine.backend.make_model`;
* ``_param_realloc`` copies (or averages, for an EMA) the source
  parameters into the target's tensors in place;
* the weight publish writes safetensors snapshots
  (``engine/checkpoint.py``): the full tree cast to the model dtype, the
  int8 serving tree beside it (``publish_quantized_int8``), and a
  manifest built from the tensors' shapes;
* ``AREAL_PROFILE_DIR`` traces each MFC with ``torch.profiler`` (a
  Chrome trace per MFC kind) instead of ``jax.profiler``;
* on a card, the worker launches its work on a CUDA stream of its own, so
  a generation server on the same card and the trainer read their results
  without waiting for each other's kernels.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.utils.data

from areal_tpu_torch.api import dataset_api, model_api, system_api
from areal_tpu_torch.api.config import ModelName
from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.base import constants, logging_, seeding
from areal_tpu_torch.base.device import resolve_device
from areal_tpu_torch.system import worker_base
from areal_tpu_torch.system.data_manager import DataManager
from areal_tpu_torch.system.redistributor import RedistribStep
from areal_tpu_torch.system.request_reply_stream import (
    NoMessage,
    Payload,
    WorkerRequestReplyStream,
)

logger = logging_.getLogger("model_worker")

NON_BLOCKING_RPCS = ("fetch", "spec", "clear_data_cache", "model_config")

#: the model's train-step counter in a recover checkpoint
MODEL_VERSION_FILE = "model_version.json"


def _count_dataset_rows(d) -> int:
    """Row count of a jsonl/json dataset abstraction without building it."""
    path = (d.args or {}).get("dataset_path")
    if not path or not os.path.exists(path):
        return 0
    if path.endswith(".jsonl"):
        with open(path) as f:
            return sum(1 for line in f if line.strip())
    import json

    with open(path) as f:
        return len(json.load(f))


class ModelWorker(worker_base.Worker):
    def _configure(self, config: system_api.ModelWorkerConfig):
        self.config = config
        self.worker_name = config.worker_name
        self.logger = logging_.getLogger(self.worker_name)
        seeding.set_random_seed(config.seed, self.worker_name)
        # the worker's engines launch on a CUDA stream of their own, so
        # that on a card shared with a generation server neither waits on
        # the other's kernels when it reads a result
        dev = resolve_device(config.device)
        self._cuda_stream = (
            torch.cuda.Stream(dev) if dev.type == "cuda" else None
        )

        from areal_tpu_torch.observability import tracing

        self._tracer = tracing.configure(
            config.trace, worker=self.worker_name
        )
        self._stream = WorkerRequestReplyStream(
            constants.experiment_name(),
            constants.trial_name(),
            config.worker_name,
        )
        self._data_manager = DataManager(
            constants.experiment_name(),
            constants.trial_name(),
            config.worker_name,
        )
        self._models: Dict[str, model_api.Model] = {}
        self._publish_lock = threading.Lock()
        self._publish_threads: List[threading.Thread] = []
        self._last_published_version: Dict[str, int] = {}
        self._backends: Dict[str, model_api.ModelBackend] = {}
        self._interfaces: Dict[str, model_api.ModelInterface] = {}

        self._tokenizer = None
        if config.tokenizer_path:
            self._tokenizer = dataset_api.load_hf_tokenizer(
                config.tokenizer_path
            )

        self._dataset = None
        self._dataloader = None
        self._data_iter = None
        self._dataset_epoch = 0
        if config.datasets and not config.use_stream_dataset:
            dp_rank, dp_size = config.dataset_shard
            datasets = [
                dataset_api.make_dataset(
                    d,
                    seed=config.dataset_seed,
                    dp_rank=dp_rank,
                    world_size=dp_size,
                    tokenizer_or_path=self._tokenizer,
                )
                for d in config.datasets
            ]
            if len(datasets) > 1:
                self._dataset = torch.utils.data.ConcatDataset(datasets)
            else:
                self._dataset = datasets[0]
        elif config.use_stream_dataset:
            from areal_tpu_torch.system.stream_dataset import PullerStreamDataset

            # epoch accounting mirrors the underlying prompt dataset size
            # (reference: stream_dataset.py:23 __len__ contract); count rows
            # cheaply instead of constructing (tokenizing) the full dataset
            size = 10**9
            if config.datasets:
                dp_rank, dp_size = config.dataset_shard
                n_rows = sum(_count_dataset_rows(d) for d in config.datasets)
                size = max(1, n_rows // max(1, dp_size))
                size *= config.stream_group_size
            self._dataset = PullerStreamDataset(
                experiment_name=constants.experiment_name(),
                trial_name=constants.trial_name(),
                puller_index=config.dataset_shard[0],
                dataset_size=size,
            )

    # -- dataset ------------------------------------------------------------

    def _ensure_loader(self, batch_size: int):
        if self._dataloader is None or self._dataloader.batch_size != batch_size:
            self._dataloader = dataset_api.SequenceSampleDataLoader(
                self._dataset,
                batch_size=batch_size,
                shuffle=not self.config.use_stream_dataset,
                seed=self.config.dataset_seed + self._dataset_epoch,
            )
            self._data_iter = iter(self._dataloader)

    def _handle_fetch(self, batch_size: int) -> Dict:
        """Next dataloader batch: store tensors locally, return metadata."""
        self._ensure_loader(batch_size)
        is_new_epoch = False
        try:
            batch = next(self._data_iter)
        except StopIteration:
            self._dataset_epoch += 1
            is_new_epoch = True
            self._dataloader = None  # reshuffle with a new epoch seed
            self._ensure_loader(batch_size)
            batch = next(self._data_iter)
        self._data_manager.store(batch)
        return {
            "meta": batch.meta(),
            "is_new_epoch": is_new_epoch,
            "epoch": self._dataset_epoch,
        }

    def _handle_spec(self) -> Dict:
        return {
            "dataset_size": len(self._dataset) if self._dataset is not None else 0,
        }

    # -- models -------------------------------------------------------------

    def _handle_initialize(self, shard: system_api.ModelShard, ft_spec) -> Dict:
        from areal_tpu_torch.engine.backend import make_model

        name = str(shard.model_name)
        mesh = shard.mesh_spec.make_mesh()
        # engines keep float32 master weights; the publish casts them to
        # the model dtype, which is what a server built from the same
        # abstraction draws (both draw in float32 first)
        model = make_model(
            shard.model, shard.model_name, mesh, tokenizer=self._tokenizer,
            device=self.config.device, dtype=torch.float32,
        )
        backend = model_api.make_backend(shard.backend)
        backend.device = self.config.device
        model = backend.initialize(model, ft_spec)
        self._models[name] = model
        self._backends[name] = backend
        self._maybe_recover_load(name, backend, model)
        if shard.eval_dataset is not None:
            model.eval_dataset = dataset_api.make_dataset(
                shard.eval_dataset,
                seed=self.config.dataset_seed,
                dp_rank=0,
                world_size=1,
                tokenizer_or_path=self._tokenizer,
            )
        self.logger.info("initialized model %s on mesh %s", name, shard.mesh_spec)
        return {"model_config": dataclasses.asdict(model.model_cfg)}

    def _maybe_recover_load(self, name: str, backend, model):
        """On a recover restart (AREAL_RECOVER=1, set by the launcher's
        restart policy), reload the model's latest recover checkpoint —
        weights, optimizer state, and version — instead of starting from the
        initial weights (reference: realhf/system/model_worker.py:723-733;
        master-side StepInfo restore alone would silently train a fresh
        model)."""
        if os.environ.get("AREAL_RECOVER") != "1":
            return
        from areal_tpu_torch.base import recover
        from areal_tpu_torch.engine.checkpoint import latest_train_state

        # cap at the master's recorded resume step: a crash between the
        # ckpt write and the recover-info write must not replay one extra
        # optimizer update
        info = recover.discover()
        max_step = info.recover_start.global_step if info else None
        base = os.path.join(constants.get_recover_path(), name)
        latest = latest_train_state(base, max_step=max_step)
        if latest is None:
            self.logger.info("recover: no checkpoint for %s; fresh start", name)
            return
        try:
            backend.load(model, latest)
        except NotImplementedError:
            return
        # the train-step counter that names published versions resumes
        # too (the JAX package restores only the engine's update count, so
        # its versions restart from 0 after a restart: ROADMAP.md section 3)
        vpath = os.path.join(latest, MODEL_VERSION_FILE)
        if os.path.exists(vpath):
            import json

            with open(vpath) as f:
                model.version = model_api.ModelVersionSteps(**json.load(f))
        self.logger.info(
            "recover: %s reloaded from %s (engine version %d, step %d)",
            name,
            latest,
            getattr(model.engine, "version", -1),
            model.version.global_step,
        )
        from areal_tpu_torch.base import name_resolve, names

        name_resolve.add(
            names.recover_load(
                constants.experiment_name(), constants.trial_name(), name
            ),
            latest,
            replace=True,
        )
        # the launcher cleared the trial's keys, so the restarted manager
        # and servers start from the initial weights at version 0: publish
        # the restored weights again, or the staleness gate (trained steps
        # minus the served version) holds every rollout back once the run
        # is more than max_head_offpolicyness steps in
        if self._has_published(model):
            self._publish_weights(name)

    def _has_published(self, model) -> bool:
        import re

        base = os.path.join(
            constants.get_param_realloc_path(), model.name.role)
        return os.path.isdir(base) and any(
            re.fullmatch(r"v\d+", d) for d in os.listdir(base))

    def _get_interface(self, rpc_name: str) -> model_api.ModelInterface:
        if rpc_name not in self._interfaces:
            self._interfaces[rpc_name] = model_api.make_interface(
                self.config.interfaces[rpc_name]
            )
        return self._interfaces[rpc_name]

    # -- hooks --------------------------------------------------------------

    def _run_hook(self, hook: Dict):
        htype = hook["type"]
        if htype == "data_transfer":
            for step in hook["steps"]:
                if isinstance(step, dict):
                    step = RedistribStep(**step)
                if step.dst == self.worker_name:
                    self._data_manager.execute_pull(step)
        elif htype == "param_realloc":
            self._param_realloc(
                hook["source"], hook["target"], hook.get("eta", 1.0)
            )
        elif htype == "save":
            self._save_model(hook["model_name"], hook["path"])
        elif htype == "publish_weights":
            self._publish_weights(hook["model_name"])
        elif htype == "offload":
            pass  # device arrays are dropped with the engine's arrays; no-op
        else:
            raise ValueError(f"unknown hook {htype}")

    def _param_realloc(self, source: str, target: str, eta: float):
        """target <- eta * source + (1 - eta) * target (EMA ref update /
        layout move), in place in the target engine's tensors.  A source
        hosted on another worker is read from its latest published
        snapshot (reference: realhf/system/model_worker.py:1046's role)."""
        from areal_tpu_torch.engine.train_engine import tree_leaves

        dst = self._models[target].engine
        src_params = (
            self._models[source].engine.params
            if source in self._models
            else self._load_published_params(source, dst)
        )
        if eta == 1.0:
            dst.set_params(src_params)
            return
        eta_ = float(eta)
        with torch.no_grad():
            for d, s_ in zip(tree_leaves(dst.params), tree_leaves(src_params)):
                s_ = s_.to(device=d.device, dtype=torch.float32)
                d.copy_((eta_ * s_ + (1 - eta_) * d.float()).to(d.dtype))

    def _load_published_params(
        self, source: str, dst_engine, deadline_s: float = 10.0
    ):
        """Latest published sharded checkpoint of ``source``, restored
        directly onto the destination engine's shardings.

        The publisher GCs old snapshots (keep-last-2), so a restore can
        race the deletion of the very version it resolved: the ``v{n}``
        dir vanishes mid-restore.  Instead of crashing, every attempt
        RE-RESOLVES the version key and retries — the GC only ever runs
        after a newer version is advertised, so the re-resolved key
        names a strictly newer, intact snapshot.  A version that failed
        once is never retried (its deletion is permanent); if no newer
        version shows up before ``deadline_s``, the race is reported as
        such."""
        import pickle as _pickle

        from areal_tpu_torch.base import name_resolve, names
        from areal_tpu_torch.engine import checkpoint

        role = source.split("@", 1)[0]
        key = names.model_version(
            constants.experiment_name(), constants.trial_name(), role
        )
        last_exc = None
        failed_versions = set()
        deadline = time.monotonic() + deadline_s
        while True:
            try:
                payload = _pickle.loads(bytes.fromhex(name_resolve.get(key)))
            except name_resolve.NameEntryNotFoundError:
                raise RuntimeError(
                    f"param_realloc: source {source!r} is not hosted on "
                    f"{self.worker_name} and has never published weights; "
                    "add a publish_weights post-hook to its train MFC"
                ) from None
            version = payload.get("version")
            if version in failed_versions:
                # same doomed version still advertised: wait for the
                # publisher to advertise the next-newer one
                if time.monotonic() > deadline:
                    break
                time.sleep(0.2)
                continue
            try:
                return checkpoint.load_params_like(
                    dst_engine.params, payload["path"]
                )
            except (FileNotFoundError, ValueError, OSError) as e:
                last_exc = e
                failed_versions.add(version)
                getattr(self, "logger", logger).warning(
                    "published checkpoint v%s of %r vanished mid-restore "
                    "(keep-last-2 GC race); waiting for a newer version",
                    version, source,
                )
                if time.monotonic() > deadline:
                    break
                time.sleep(0.2)
        raise RuntimeError(
            f"param_realloc: published checkpoint for {source!r} kept "
            "disappearing mid-restore (GC race) and no newer version was "
            f"advertised within {deadline_s:.0f}s"
        ) from last_exc

    def _publish_weights(self, model_name: str):
        """Write current weights to the realloc dir as a SHARDED raw-param
        checkpoint (each host writes its own shards, inference dtype — no
        host gather, no HF conversion) and publish the version in
        name_resolve — the train->generation weight sync trigger (reference:
        realhf/system/model_worker.py:787-812 post-train realloc save +
        version publish; gserver manager picks it up and hot-swaps)."""
        import pickle as _pickle

        from areal_tpu_torch.base import name_resolve, names
        from areal_tpu_torch.engine import checkpoint

        model = self._models[model_name]
        version = model.version.global_step
        role = model.name.role
        path = os.path.join(
            constants.get_param_realloc_path(), role, f"v{version}"
        )
        tik = time.monotonic()
        from areal_tpu_torch.models.transformer import torch_dtype

        cast = torch_dtype(model.model_cfg.dtype)
        # non-blocking: the leaves are cast and copied to the host now (the
        # next train step updates them in place), the file is written on
        # a background thread
        checkpoint.save_params(
            model.engine.params,
            path,
            cast_dtype=cast,
            wait=False,
        )
        publish_s = time.monotonic() - tik
        version_key = names.model_version(
            constants.experiment_name(), constants.trial_name(), role
        )
        payload = _pickle.dumps(
            {"version": version, "path": path, "format": "params"}
        ).hex()
        # layout/dtype manifest from the tensors' shapes and the cast
        # dtype (meta tensors: no data); consumers (the gen servers' staged
        # restore) validate against it before reading any tensor, and its
        # presence is a cheap liveness probe for a snapshot racing
        # keep-last-2 GC
        from areal_tpu_torch.engine.train_engine import tree_map

        manifest_params = tree_map(
            lambda t: torch.empty(tuple(t.shape), dtype=cast, device="meta"),
            model.engine.params,
        )
        # int8 serving tree: also publish the quantized format to the
        # sibling v{N}-int8 dir and advertise it in the manifest.
        # Quantization runs now (its tensors are independent of the
        # parameters the next step updates); a failure only withholds the
        # advertisement
        serving_quant = None
        quant_s = 0.0
        if getattr(
            getattr(self, "config", None), "publish_quantized_int8", True
        ):
            qpath = checkpoint.quant_snapshot_path(path)
            tq = time.monotonic()
            try:
                qavals = checkpoint.save_quantized_params(
                    model.engine.params,
                    qpath,
                    cast_dtype=cast,
                    wait=False,
                )
                if qavals is not None:
                    serving_quant = {
                        "int8": checkpoint.quant_manifest_entry(
                            qavals, qpath
                        )
                    }
            except Exception:  # noqa: BLE001 - full tree still publishes
                self.logger.warning(
                    "int8 serving-tree publish failed for %s; consumers "
                    "fall back to the full-precision tree",
                    qpath,
                    exc_info=True,
                )
            quant_s = time.monotonic() - tq
        from areal_tpu_torch.observability import get_registry

        reg = get_registry()
        reg.histogram("areal_weight_publish_seconds").observe(
            publish_s, part="full"
        )
        reg.histogram("areal_weight_publish_seconds").observe(
            quant_s, part="int8"
        )

        def _commit():
            # advertise the version only once the checkpoint is durable,
            # then gc older snapshots (keep last 2; ref gserver_manager
            # :287-305)
            try:
                checkpoint.wait_for_saves()
                # the OPTIONAL quant sibling settles on its own
                # checkpointer: a failed int8 commit only drops the
                # advertisement — the durable full-precision publish
                # below proceeds regardless
                quant_ok = serving_quant
                if quant_ok is not None:
                    try:
                        checkpoint.wait_for_quant_saves()
                    except Exception:  # noqa: BLE001 - degrade, don't die
                        self.logger.warning(
                            "int8 serving-tree commit failed for v%d; "
                            "advertising the full-precision tree only",
                            version,
                            exc_info=True,
                        )
                        quant_ok = None
                try:
                    checkpoint.write_manifest(
                        manifest_params,
                        path,
                        version=version,
                        serving_quant=quant_ok,
                    )
                except OSError:
                    # snapshot already GC'd by a newer publish: the
                    # version check below returns without advertising
                    self.logger.warning(
                        "manifest write failed for %s", path
                    )
                with self._publish_lock:
                    # concurrent commits may finish out of order (the
                    # shared checkpointer waits for ALL pending saves);
                    # never let an older version overwrite a newer key
                    if version <= self._last_published_version.get(role, -1):
                        return
                    self._last_published_version[role] = version
                    name_resolve.add(version_key, payload, replace=True)
                    base = os.path.dirname(path)
                    import re as _re
                    import shutil

                    snaps = sorted(
                        (
                            d
                            for d in os.listdir(base)
                            # only version dirs (not their -int8 siblings)
                            if _re.fullmatch(r"v\d+", d)
                        ),
                        key=lambda d: int(d[1:]),
                    )
                    keep = set(snaps[-2:])
                    # reap old versions AND their -int8 serving-tree
                    # siblings together (a kept version keeps its pair)
                    for d in os.listdir(base):
                        m = _re.fullmatch(r"(v\d+)(-int8)?", d)
                        if m is None or m.group(1) in keep:
                            continue
                        shutil.rmtree(
                            os.path.join(base, d), ignore_errors=True
                        )
                commit_s = time.monotonic() - tik
                reg.histogram("areal_weight_publish_seconds").observe(
                    commit_s, part="commit"
                )
                self.logger.debug(
                    "published %s v%d in %.2fs (async commit)",
                    model_name,
                    version,
                    commit_s,
                )
            except Exception:  # noqa: BLE001 - version stays unadvertised
                self.logger.exception("weight publish v%d failed", version)

        t = threading.Thread(
            target=_commit, daemon=True, name=f"publish-{role}-v{version}"
        )
        # prune finished commits so the list stays O(in-flight), not O(steps)
        self._publish_threads = [
            x for x in self._publish_threads if x.is_alive()
        ]
        self._publish_threads.append(t)
        t.start()

    def _save_model(self, model_name: str, path: str):
        model = self._models[model_name]
        # write-then-rename so watchers (the automatic evaluator's checkpoint
        # discovery) never see a half-written HF dir; the tmp name does not
        # match the epoch...globalstep... pattern the evaluator scans for
        tmp = path.rstrip("/") + f".tmp-{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        model.engine.save_hf(tmp, model.backend_name, model.tokenizer)
        if os.path.isdir(path):
            import shutil

            shutil.rmtree(path)
        os.replace(tmp, path)

    def _ckpt_model(self, model_name: str, path: str):
        """Recover checkpoint: the train state (parameters, optimizer and
        the engine's update count) and the model's train-step counter,
        written first, so a whole train state always has it."""
        import json

        model = self._models[model_name]
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, MODEL_VERSION_FILE), "w") as f:
            json.dump(dataclasses.asdict(model.version), f)
        try:
            self._backends[model_name].save(model, path)
        except NotImplementedError:
            pass

    # -- MFC execution ------------------------------------------------------

    def _handle_model_rpc(self, req: Payload) -> Dict:
        spec = req.data
        rpc_name = spec["rpc_name"]
        model_name = spec["model_name"]
        handle = spec["handle_name"]
        ids = spec["ids"]
        input_keys = spec.get("input_keys")
        mb_spec = spec.get("mb_spec") or MicroBatchSpec()

        model = self._models[model_name]
        interface = self._get_interface(rpc_name)
        if handle == "evaluate":
            res = interface.evaluate(
                model, getattr(model, "eval_dataset", None)
            )
            return {"stats": res, "elapsed": 0.0}
        data = self._data_manager.get_batch(ids, input_keys)

        # optional per-MFC profiling (reference: the torch.profiler wrap in
        # realhf/system/model_worker.py:829 __maybe_profile_rpc); set
        # AREAL_PROFILE_DIR to collect a Chrome trace per MFC kind
        profile_dir = os.environ.get("AREAL_PROFILE_DIR")
        prof_ctx = None
        if profile_dir:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof_ctx = torch.profiler.profile(activities=activities)
            prof_ctx.__enter__()
        tik = time.monotonic()
        res: Any = None
        try:
            if handle == "train_step":
                res = interface.train_step(model, data, mb_spec)
                self._trace_train_consumption(model_name, model, ids)
            elif handle == "inference":
                res = interface.inference(model, data, mb_spec)
            elif handle == "generate":
                res = interface.generate(model, data, mb_spec)
            else:
                raise ValueError(f"unknown MFC handle {handle}")
        finally:
            if prof_ctx is not None:
                prof_ctx.__exit__(None, None, None)
                os.makedirs(profile_dir, exist_ok=True)
                prof_ctx.export_chrome_trace(
                    os.path.join(profile_dir, f"{rpc_name}.json")
                )
        elapsed = time.monotonic() - tik
        if (handle == "train_step" and isinstance(res, dict)
                and getattr(self, "_cuda_stream", None) is not None):
            # this process's allocator: the master holds no context
            from areal_tpu_torch.base.monitor import device_memory_stats

            res.update(device_memory_stats())

        reply: Dict = {"elapsed": elapsed}
        reply.update(self._mfc_flops_stats(model, handle, data, res))
        if isinstance(res, SequenceSample):
            self._data_manager.store(res)
            reply["meta"] = res.meta()
            reply["output_keys"] = sorted(res.keys)
        elif isinstance(res, dict):
            reply["stats"] = res
        return reply

    def _trace_train_consumption(self, model_name: str, model, ids):
        """Flight recorder: which train step consumed which qids, with
        per-sample weight-version staleness (current engine version minus
        the sample's ``version_end``) — the off-policyness the paper's
        staleness gate bounds, finally measurable per sample."""
        from areal_tpu_torch.observability.tracing import record_train_consumption

        try:
            version = int(model.version.global_step)
            vends = None
            try:
                vsample = self._data_manager.get_batch(
                    list(ids), ["version_end"]
                )
                import numpy as _np

                vends = _np.asarray(
                    vsample.data["version_end"]
                ).reshape(-1).tolist()
            except Exception:  # noqa: BLE001 - SFT/DPO have no versions
                vends = None
            record_train_consumption(
                ids, version, vends, version,
                model=model_name, tracer=self._tracer,
            )
        except Exception:  # noqa: BLE001 - tracing never fails a train step
            self.logger.debug("train consumption trace failed", exc_info=True)

    def _mfc_flops_stats(self, model, handle: str, data, res) -> Dict:
        """Analytic FLOPs + token count for the master's throughput logs
        (reference: realhf/system/flops_counter.py feeding
        master_worker._log_training_stats)."""
        from areal_tpu_torch.system import flops_counter

        cfg = getattr(model, "model_cfg", None)
        if cfg is None:
            return {}

        def _lens(sample, key):
            # flatten per ANSWER: grouped sampling stores n independent
            # sequences per id; summing them per id would square-inflate
            # the attention term
            return [
                int(l) for per_id in sample.seqlens[key] for l in per_id
            ]

        try:
            if handle == "generate" and isinstance(res, SequenceSample):
                key = (
                    "packed_input_ids"
                    if "packed_input_ids" in res.keys
                    else sorted(res.keys)[0]
                )
                # per-ANSWER lengths: each answer is an independent
                # prefill+decode over its own cache
                full = _lens(res, key)
                pkey = next(
                    (
                        k
                        for k in ("packed_prompts", "packed_input_ids")
                        if k in data.keys
                    ),
                    None,
                )
                prompts = []
                if pkey:
                    for per_id, out_per_id in zip(
                        data.seqlens[pkey], res.seqlens[key]
                    ):
                        prompts.extend([int(sum(per_id))] * len(out_per_id))
                else:
                    prompts = [0] * len(full)
                fl = flops_counter.mfc_flops(handle, cfg, full, prompts)
                n_tokens = sum(full)
            else:
                key = (
                    "packed_input_ids"
                    if "packed_input_ids" in data.keys
                    else sorted(data.keys)[0]
                )
                lens = _lens(data, key)
                fl = flops_counter.mfc_flops(handle, cfg, lens)
                n_tokens = sum(lens)
        except Exception:  # noqa: BLE001 - accounting must never kill an MFC
            return {}
        return {"flops": fl, "n_tokens": n_tokens}

    # -- poll ---------------------------------------------------------------

    def _handle_request(self, req: Payload):
        if self._cuda_stream is None:
            return self._handle_request_on_stream(req)
        with torch.cuda.stream(self._cuda_stream):
            return self._handle_request_on_stream(req)

    def _handle_request_on_stream(self, req: Payload):
        for hook in req.pre_hooks:
            self._run_hook(hook)
        h = req.handle_name
        if h == "fetch":
            resp = self._handle_fetch(**(req.data or {}))
        elif h == "spec":
            resp = self._handle_spec()
        elif h == "clear_data_cache":
            self._data_manager.drop(req.data["ids"])
            resp = "ok"
        elif h == "model_config":
            m = self._models[req.data["model_name"]]
            resp = dataclasses.asdict(m.model_cfg)
        elif h == "initialize":
            resp = self._handle_initialize(**req.data)
        elif h == "initialize_all":
            resp = {
                str(s.model_name): self._handle_initialize(
                    s, req.data["ft_spec"]
                )
                for s in self.config.shards
            }
        elif h == "save":
            self._save_model(req.data["model_name"], req.data["path"])
            resp = "ok"
        elif h == "ckpt":
            self._ckpt_model(req.data["model_name"], req.data["path"])
            resp = "ok"
        elif h in ("train_step", "inference", "generate", "evaluate"):
            resp = self._handle_model_rpc(req)
        elif h == "ping":
            resp = "pong"
        else:
            raise ValueError(f"unknown request {h}")
        for hook in req.post_hooks:
            self._run_hook(hook)
        self._stream.reply(req, resp)

    def _poll(self) -> worker_base.PollResult:
        count = 0
        for _ in range(8):
            try:
                req = self._stream.poll_request()
            except NoMessage:
                break
            try:
                self._handle_request(req)
            except Exception as e:  # noqa: BLE001 - propagate via reply
                self.logger.exception(
                    "request %s failed", req.handle_name
                )
                self._stream.reply(
                    req, {"__worker_error__": repr(e)}
                )
            count += 1
        return worker_base.PollResult(sample_count=count)

    def _exit_hook(self):
        # drain in-flight publish commits: the final trained version must be
        # advertised before the process goes away
        for t in getattr(self, "_publish_threads", []):
            t.join(timeout=60)
        if hasattr(self, "_data_manager"):
            self._data_manager.close()
        if hasattr(self, "_stream"):
            self._stream.close()
