"""Sync PPO math experiment: the 7-MFC graph with its pruning options
(port of ``areal_tpu/experiments/ppo_math_exp.py``; reference:
realhf/experiments/common/ppo_math_exp.py:29,120-341 — actor_gen ->
{rew_inf, ref_inf, critic_inf, actor_inf} -> {actor_train, critic_train};
disable_value drops the critic pair, kl_ctl=0 drops ref_inf,
use_decoupled_loss adds actor_inf, fuse_rew_ref merges rew_inf into the
reference model's MFC, reward_source="model" scores with a trained
reward model; ref_ema_eta moves the reference model toward the actor
after each actor step through a ParamReallocHook).

Every model of the graph runs on the one device of its model worker
(``experiments/common.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from areal_tpu_torch.api import system_api
from areal_tpu_torch.api.config import (
    DatasetAbstraction,
    ModelAbstraction,
    ModelBackendAbstraction,
    ModelInterfaceAbstraction,
    ModelName,
)
from areal_tpu_torch.api.data import MicroBatchSpec
from areal_tpu_torch.api.dfg import (
    MFCDef,
    ModelInterfaceType,
    ParamReallocHook,
)
from areal_tpu_torch.api.model_api import GenerationHyperparameters
from areal_tpu_torch.api.system_api import ModelShard
from areal_tpu_torch.engine.optimizer import OptimizerConfig
from areal_tpu_torch.experiments.common import CommonExperimentConfig


@dataclasses.dataclass
class PPOHyperparameters:
    """(reference: realhf/api/cli_args.py:597)"""

    gen: GenerationHyperparameters = dataclasses.field(
        default_factory=GenerationHyperparameters
    )
    ppo_n_minibatches: int = 4
    eps_clip: float = 0.2
    c_clip: Optional[float] = None
    value_eps_clip: float = 0.2
    disable_value: bool = False
    reward_output_scaling: float = 1.0
    reward_output_bias: float = 0.0
    max_reward_clip: float = 20.0
    mask_no_eos_with_zero: bool = False
    discount: float = 1.0
    gae_lambda: float = 1.0
    adv_norm: bool = True
    group_adv_norm: bool = False
    kl_ctl: float = 0.1
    adaptive_kl_ctl: bool = False
    use_decoupled_loss: bool = False
    behav_imp_weight_cap: Optional[float] = None
    recompute_logprob: bool = False
    ref_ema_eta: Optional[float] = None  # EMA trainer->ref update


@dataclasses.dataclass
class PPOMathExperiment(CommonExperimentConfig):
    actor: ModelAbstraction = None
    critic: ModelAbstraction = None  # derived from actor if None
    ref: ModelAbstraction = None  # derived from actor if None
    dataset: DatasetAbstraction = None
    ppo: PPOHyperparameters = dataclasses.field(
        default_factory=PPOHyperparameters
    )
    group_size: int = 1
    train_bs_n_seqs: int = 8
    mb_spec: MicroBatchSpec = dataclasses.field(default_factory=MicroBatchSpec)
    actor_optimizer: OptimizerConfig = dataclasses.field(
        default_factory=lambda: OptimizerConfig(lr=1e-6)
    )
    critic_optimizer: OptimizerConfig = dataclasses.field(
        default_factory=lambda: OptimizerConfig(lr=5e-6)
    )
    # collapse rew_inf + ref_inf into one fused MFC on the ref model
    # (reference: fused_interface.py; saves a dispatch + overlaps the CPU
    # verifier with the ref forward). Only takes effect when use_ref.
    fuse_rew_ref: bool = False
    # where PPO rewards come from (the reward-MFC slot, reference:
    # realhf/experiments/common/ppo_math_exp.py:120-341):
    #   "rule"  — the math/code verifier (rw_math interface)
    #   "model" — a TRAINED reward model (rw_train.inference on a frozen
    #             critic-head checkpoint; completes SFT -> RM -> PPO)
    reward_source: str = "rule"
    # the frozen RM for reward_source="model" (e.g. an "hf" abstraction
    # pointing at an rw-experiment checkpoint, is_critic=True); defaults
    # to a critic twin of the actor — useful only for tests
    reward_model: ModelAbstraction = None

    def _main_model(self):
        return self.actor

    @property
    def use_critic(self) -> bool:
        return not self.ppo.disable_value

    @property
    def use_ref(self) -> bool:
        return self.ppo.kl_ctl != 0.0

    def initial_setup(self) -> system_api.ExperimentConfig:
        self.prepare_common()  # allocation_mode (refused) and tokenizer
        ppo = self.ppo
        actor = ModelName("actor")
        critic = ModelName("critic")
        ref = ModelName("ref")
        reward = ModelName("reward")

        actor_iface_args = dict(
            n_minibatches=ppo.ppo_n_minibatches,
            gconfig=ppo.gen,
            kl_ctl=ppo.kl_ctl,
            adaptive_kl_ctl=ppo.adaptive_kl_ctl,
            eps_clip=ppo.eps_clip,
            c_clip=ppo.c_clip,
            discount=ppo.discount,
            gae_lambda=ppo.gae_lambda,
            max_reward_clip=ppo.max_reward_clip,
            reward_scaling=ppo.reward_output_scaling,
            reward_bias=ppo.reward_output_bias,
            mask_no_eos_with_zero=ppo.mask_no_eos_with_zero,
            adv_norm=ppo.adv_norm,
            group_adv_norm=ppo.group_adv_norm,
            group_size=self.group_size,
            disable_value=ppo.disable_value,
            temperature=ppo.gen.temperature,
            use_decoupled_loss=ppo.use_decoupled_loss,
            behav_imp_weight_cap=ppo.behav_imp_weight_cap,
        )
        actor_iface = ModelInterfaceAbstraction("ppo_actor", actor_iface_args)
        ref_iface = ModelInterfaceAbstraction(
            "ppo_actor",
            {**actor_iface_args, "use_decoupled_loss": False},
        )
        prox_iface = ModelInterfaceAbstraction(
            "ppo_actor",
            {**actor_iface_args, "use_decoupled_loss": True},
        )
        critic_iface = ModelInterfaceAbstraction(
            "ppo_critic",
            dict(
                n_minibatches=ppo.ppo_n_minibatches,
                value_eps_clip=ppo.value_eps_clip,
                kl_ctl=ppo.kl_ctl,
                discount=ppo.discount,
                gae_lambda=ppo.gae_lambda,
                max_reward_clip=ppo.max_reward_clip,
                mask_no_eos_with_zero=ppo.mask_no_eos_with_zero,
            ),
        )
        assert self.reward_source in ("rule", "model"), self.reward_source
        if self.reward_source == "model":
            from areal_tpu_torch.interfaces.rm_interface import (  # noqa: F401
                RewardModelInterface,
            )

            rw_iface = ModelInterfaceAbstraction("rw_train", {})
        else:
            rw_iface = ModelInterfaceAbstraction(
                "rw_math", {"group_size": self.group_size}
            )

        n = self.train_bs_n_seqs
        rpcs = []
        interfaces = {}

        actor_gen = MFCDef(
            name="actor_gen",
            model_name=actor,
            interface_type=ModelInterfaceType.GENERATE,
            interface_impl=actor_iface,
            input_keys=("packed_prompts",),
            output_keys=(
                "packed_input_ids",
                "packed_logprobs",
                "prompt_mask",
                "seq_no_eos_mask",
            ),
            n_seqs=n,
        )
        rpcs.append(actor_gen)
        interfaces["actor_gen"] = actor_iface

        # a model-based reward runs on ITS OWN weights, so it cannot fuse
        # into the ref model's MFC
        fused = (
            self.fuse_rew_ref and self.use_ref
            and self.reward_source == "rule"
        )
        if fused:
            from areal_tpu_torch.interfaces.fused_interface import (  # noqa: F401
                FusedInferenceInterface,
            )

            fused_iface = ModelInterfaceAbstraction(
                "fused-inference",
                {"interfaces": {"rew": rw_iface, "ref": ref_iface}},
            )
            rpcs.append(
                MFCDef(
                    name="rew_ref_inf",
                    model_name=ref,
                    interface_type=ModelInterfaceType.INFERENCE,
                    interface_impl=fused_iface,
                    input_keys=("packed_input_ids", "prompt_mask"),
                    output_keys=("rewards", "packed_ref_logprobs"),
                    n_seqs=n,
                )
            )
            interfaces["rew_ref_inf"] = fused_iface
        else:
            rew_inf = MFCDef(
                name="rew_inf",
                model_name=reward,
                interface_type=ModelInterfaceType.INFERENCE,
                interface_impl=rw_iface,
                input_keys=("packed_input_ids", "prompt_mask"),
                output_keys=("rewards",),
                n_seqs=n,
            )
            rpcs.append(rew_inf)
            interfaces["rew_inf"] = rw_iface

        train_input_keys = [
            "packed_input_ids",
            "packed_logprobs",
            "prompt_mask",
            "rewards",
            "seq_no_eos_mask",
        ]
        if self.use_ref:
            if not fused:
                rpcs.append(
                    MFCDef(
                        name="ref_inf",
                        model_name=ref,
                        interface_type=ModelInterfaceType.INFERENCE,
                        interface_impl=ref_iface,
                        input_keys=("packed_input_ids", "prompt_mask"),
                        output_keys=("packed_ref_logprobs",),
                        n_seqs=n,
                    )
                )
                interfaces["ref_inf"] = ref_iface
            train_input_keys.append("packed_ref_logprobs")
        if self.use_critic:
            rpcs.append(
                MFCDef(
                    name="critic_inf",
                    model_name=critic,
                    interface_type=ModelInterfaceType.INFERENCE,
                    interface_impl=critic_iface,
                    input_keys=("packed_input_ids",),
                    output_keys=("values",),
                    n_seqs=n,
                )
            )
            interfaces["critic_inf"] = critic_iface
            train_input_keys.append("values")
        if ppo.use_decoupled_loss or ppo.recompute_logprob:
            rpcs.append(
                MFCDef(
                    name="actor_inf",
                    model_name=actor,
                    interface_type=ModelInterfaceType.INFERENCE,
                    interface_impl=prox_iface,
                    input_keys=("packed_input_ids", "prompt_mask"),
                    output_keys=("prox_logp",),
                    n_seqs=n,
                )
            )
            interfaces["actor_inf"] = prox_iface
            train_input_keys.append("prox_logp")

        actor_post_hooks = []
        if ppo.ref_ema_eta is not None and self.use_ref:
            actor_post_hooks.append(
                ParamReallocHook(target=ref, eta=ppo.ref_ema_eta)
            )
        actor_train = MFCDef(
            name="actor_train",
            model_name=actor,
            interface_type=ModelInterfaceType.TRAIN_STEP,
            interface_impl=actor_iface,
            input_keys=tuple(train_input_keys),
            n_seqs=n,
            mb_spec=self.mb_spec,
            log_return_value=True,
            post_hooks=actor_post_hooks,
        )
        rpcs.append(actor_train)
        interfaces["actor_train"] = actor_iface
        if self.use_critic:
            rpcs.append(
                MFCDef(
                    name="critic_train",
                    model_name=critic,
                    interface_type=ModelInterfaceType.TRAIN_STEP,
                    interface_impl=critic_iface,
                    input_keys=tuple(train_input_keys),
                    n_seqs=n,
                    mb_spec=self.mb_spec,
                )
            )
            interfaces["critic_train"] = critic_iface

        # -- model shards ---------------------------------------------------
        def critic_model_from(actor_model: ModelAbstraction):
            if actor_model.type_ == "hf":
                return ModelAbstraction(
                    "hf", {**actor_model.args, "is_critic": True}
                )
            args = dict(actor_model.args)
            if "config" in args and hasattr(args["config"], "__dict__"):
                args["config"] = dataclasses.replace(
                    args["config"], is_critic=True, tied_embedding=False
                )
            else:
                args["is_critic"] = True
            return ModelAbstraction(actor_model.type_, args)

        shards = [
            ModelShard(
                model_name=actor,
                model=self.actor,
                backend=ModelBackendAbstraction(
                    "train", {"optimizer": self.actor_optimizer}
                ),
                mesh_spec=self.mesh_spec,
            ),
        ]
        if not fused:
            if self.reward_source == "model":
                # frozen critic-head scorer served by the inference backend
                rm_model = self.reward_model or critic_model_from(self.actor)
                shards.append(
                    ModelShard(
                        model_name=reward,
                        model=rm_model,
                        backend=ModelBackendAbstraction("inference"),
                        mesh_spec=self.mesh_spec,
                    )
                )
            else:
                shards.append(
                    ModelShard(
                        model_name=reward,
                        model=ModelAbstraction("null"),
                        backend=ModelBackendAbstraction("null"),
                        mesh_spec=self.mesh_spec,
                    )
                )
        if self.use_ref:
            shards.append(
                ModelShard(
                    model_name=ref,
                    model=self.ref or self.actor,
                    backend=ModelBackendAbstraction("inference"),
                    mesh_spec=self.mesh_spec,
                )
            )
        if self.use_critic:
            shards.append(
                ModelShard(
                    model_name=critic,
                    model=self.critic or critic_model_from(self.actor),
                    backend=ModelBackendAbstraction(
                        "train", {"optimizer": self.critic_optimizer}
                    ),
                    mesh_spec=self.mesh_spec,
                )
            )

        workers = self.build_model_workers(shards, interfaces, [self.dataset])
        return self.make_config(rpcs, workers)


system_api.register_experiment("ppo_math", PPOMathExperiment)
