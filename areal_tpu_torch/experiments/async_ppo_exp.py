"""Asynchronous PPO experiment: a decoupled rollout cluster and trainer
(port of ``areal_tpu/experiments/async_ppo_exp.py``; reference:
realhf/experiments/async_exp/async_rl_exp.py:59 and
async_ppo_math_exp.py:26).

The trainer's graph is {ref_inf?, actor_inf?, actor_train (+ the critic
pair)}; trajectories arrive via
the rollout workers' push stream into the trainer's PullerStreamDataset;
after each actor train step the new weights are published and the gserver
manager swaps them into every generation server.

What differs from the JAX package: each generation server runs on one
device (``device="cpu"`` under ``force_cpu_devices=1``); allocation
strings are refused (``experiments/common.py``); and the multi-turn agent
is not ported (ROADMAP.md queue 1, item 14).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from areal_tpu_torch.api import system_api
from areal_tpu_torch.api.config import (
    AgentAbstraction,
    DatasetAbstraction,
    EnvServiceAbstraction,
    ModelAbstraction,
    ModelBackendAbstraction,
    ModelInterfaceAbstraction,
    ModelName,
)
from areal_tpu_torch.api.dfg import MFCDef, ModelInterfaceType
from areal_tpu_torch.api.system_api import (
    GenServerConfig,
    GserverManagerConfig,
    ModelShard,
    RolloutWorkerConfig,
)
from areal_tpu_torch.experiments.ppo_math_exp import PPOMathExperiment


@dataclasses.dataclass
class AsyncPPOMathExperiment(PPOMathExperiment):
    """Extends the sync experiment with the rollout cluster options
    (reference: realhf/api/cli_args.py:1104 ``AsyncRLOptions``)."""

    n_rollout_workers: int = 1
    n_gen_servers: int = 1
    max_head_offpolicyness: int = 0
    # round_robin | least_requests | least_token_usage (KV-pressure-aware;
    # the continuation-refreshed estimate, gserver_manager._schedule)
    gen_schedule_policy: str = "least_requests"
    max_concurrent_rollouts: Optional[int] = None
    new_tokens_per_chunk: int = 1 << 30
    flush_request_timeout: float = 120.0
    gen_kv_cache_len: int = 32768
    gen_max_concurrent_batch: int = 16
    gen_chunk_size: int = 64  # measured on v5e: 3.7k tok/s @64 vs 3.9k @128
    # paged-KV serving knobs (engine/inference_server.py): auto picks the
    # block pool at kv_cache_len >= 2k; pool tokens default to
    # max_batch * kv_cache_len (set smaller for 32k-context serving)
    gen_cache_mode: str = "auto"
    gen_page_size: int = 1024
    gen_kv_pool_tokens: Optional[int] = None
    gen_prefill_chunk_tokens: int = 1024
    # decode-pipeline ring depth (chunks in flight; 1 = unpipelined) and
    # measured dispatch-table overrides (None = engine/dispatch.py
    # defaults; pin values a bench.py decode A/B derived for this chip)
    gen_pipeline_depth: int = 2
    gen_paged_min_cache_len: Optional[int] = None
    gen_deep_kernel_min_context: Optional[int] = None
    # device index hosting each gen server's engine (trainer/gen split)
    gen_device_start: Optional[int] = None
    success_rate_lb: float = 0.0
    success_rate_ub: float = 1.0
    # agent selection (reference: async_ppo_math_exp overrides the agent;
    # "math-multi-turn" enables the retry-with-feedback loop)
    agent_type: str = "math-single-step"
    num_turns: int = 5
    turn_level_discount: float = 1.0

    def initial_setup(self) -> system_api.ExperimentConfig:
        if self.agent_type == "math-multi-turn":
            raise NotImplementedError(
                "the multi-turn agent (agent_type='math-multi-turn') is not "
                "ported to areal_tpu_torch yet (ROADMAP.md queue 1, item 14)"
            )
        gen_tp = 1
        cfg = super().initial_setup()
        ppo = self.ppo
        actor = ModelName("actor")

        # -- trainer side: strip gen + reward MFCs, switch to stream data ---
        keep = {
            "actor_train",
            "critic_train",
            "critic_inf",
            "ref_inf",
            "actor_inf",
        }
        rpcs = [r for r in cfg.master.model_rpcs if r.name in keep]
        for r in rpcs:
            r._G = None
            # rewards/logprobs/seq masks come with the trajectories now
            if r.name in ("ref_inf", "actor_inf"):
                r.input_keys = ("packed_input_ids", "prompt_mask")
        # publish weights to the generation cluster after each actor step
        actor_train = next(r for r in rpcs if r.name == "actor_train")
        actor_train.post_hooks = list(actor_train.post_hooks) + [
            {"type": "publish_weights", "model_name": str(actor)}
        ]
        cfg.master.model_rpcs = rpcs
        cfg.master.model_groups = {}  # recomputed in lazy_init

        for w in cfg.model_workers:
            w.shards = [s for s in w.shards if s.model_name.role != "reward"]
            w.interfaces = {
                k: v for k, v in w.interfaces.items() if k in keep
            }
            w.use_stream_dataset = True
            w.stream_group_size = self.group_size

        # -- rollout cluster ------------------------------------------------
        gen_gconfig = ppo.gen.new(n=self.group_size)
        from areal_tpu_torch.base.topology import MeshSpec

        cfg.gen_servers = [
            GenServerConfig(
                worker_name=f"gen_server_{i}",
                model=self.actor,
                # each server owns its OWN (usually tiny) mesh: 1 chip per
                # replica, or a model-axis TP span when the allocation's gen
                # spec asks for it — never the trainer's mesh shape
                mesh_spec=MeshSpec(model=gen_tp),
                tokenizer_path=self.tokenizer_path,
                max_concurrent_batch=self.gen_max_concurrent_batch,
                kv_cache_len=self.gen_kv_cache_len,
                chunk_size=self.gen_chunk_size,
                temperature=ppo.gen.temperature,
                cache_mode=self.gen_cache_mode,
                page_size=self.gen_page_size,
                kv_pool_tokens=self.gen_kv_pool_tokens,
                prefill_chunk_tokens=self.gen_prefill_chunk_tokens,
                pipeline_depth=self.gen_pipeline_depth,
                paged_min_cache_len=self.gen_paged_min_cache_len,
                deep_kernel_min_context=self.gen_deep_kernel_min_context,
                device=self.worker_device(),
                device_idx=(
                    self.gen_device_start + i * gen_tp
                    if self.gen_device_start is not None
                    else None
                ),
            )
            for i in range(self.n_gen_servers)
        ]
        # staleness accounting converts rollouts -> sequences via group_size;
        # the multi-turn agent emits ONE answer per turn (1..num_turns seqs
        # per rollout), so counting group_size seqs per rollout would
        # over-count and can gate allocation forever (deadlock: allocations
        # stop before a train batch can fill). Count the guaranteed minimum.
        staleness_group_size = (
            1 if self.agent_type == "math-multi-turn" else self.group_size
        )
        cfg.gserver_manager = GserverManagerConfig(
            n_servers=self.n_gen_servers,
            schedule_policy=self.gen_schedule_policy,
            max_head_offpolicyness=self.max_head_offpolicyness,
            train_batch_size=self.train_bs_n_seqs,
            group_size=staleness_group_size,
            max_concurrent_rollouts=self.max_concurrent_rollouts,
            flush_request_timeout=self.flush_request_timeout,
        )
        if self.agent_type == "math-multi-turn":
            agent_abs = AgentAbstraction(
                "math-multi-turn",
                {
                    "gconfig": gen_gconfig,
                    "tokenizer_path": self.tokenizer_path,
                    "num_turns": self.num_turns,
                    "turn_level_discount": self.turn_level_discount,
                },
            )
        else:
            agent_abs = AgentAbstraction(
                self.agent_type,
                {
                    "gconfig": gen_gconfig,
                    "success_rate_lb": self.success_rate_lb,
                    "success_rate_ub": self.success_rate_ub,
                },
            )
        cfg.rollout_workers = [
            RolloutWorkerConfig(
                worker_name=f"rollout_worker_{i}",
                agent=agent_abs,
                env=EnvServiceAbstraction(
                    "math-code-single-step",
                    {"tokenizer_path": self.tokenizer_path},
                ),
                gconfig=gen_gconfig,
                datasets=[self.dataset],
                tokenizer_path=self.tokenizer_path,
                dataset_shard=(i, self.n_rollout_workers),
                dataset_seed=self.seed,
                new_tokens_per_chunk=self.new_tokens_per_chunk,
            )
            for i in range(self.n_rollout_workers)
        ]
        return cfg.lazy_init()


system_api.register_experiment("async_ppo_math", AsyncPPOMathExperiment)
