"""The torch port stands alone: none of its modules (nor chip_smoke.py)
imports JAX or anything of ``areal_tpu``; its entry points run on CUDA
unless the caller asks for the CPU, and raise when CUDA is absent; its
kernel wrapper never falls back on a non-CPU tensor; and what the slice
leaves out is refused, not ignored."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from areal_tpu_torch.engine.inference_server import ContinuousBatchingEngine
from areal_tpu_torch.engine.sampling import SamplingParams
from areal_tpu_torch.engine.spec_decode import SpecDecodeParams
from areal_tpu_torch.engine.train_engine import TrainEngine
from areal_tpu_torch.models.config import tiny_config
from areal_tpu_torch.models.convert import params_from_jax
from areal_tpu_torch.models.transformer import init_params
from areal_tpu_torch.ops import _build
from areal_tpu_torch.ops import decode_attention as tda
from areal_tpu_torch.ops import paged_attention as tpa

REPO = Path(__file__).resolve().parents[1]

#: the modules of the weight-publication and generation-server slice
SERVING_MODULES = [
    f"areal_tpu_torch.{m}" for m in (
        "base.constants", "base.logging_", "base.names", "base.name_resolve",
        "base.network", "api.config", "api.system_api", "api.dataset_api",
        "observability", "observability.registry", "observability.latency",
        "observability.tracing", "engine.checkpoint", "engine.backend",
        "engine.inference_server", "system.worker_base",
        "system.generation_server",
    )
]

#: the modules of the async-PPO loop's slice (the rollout system, the model
#: and master workers, the experiments and the local runner)
LOOP_MODULES = [
    f"areal_tpu_torch.{m}" for m in (
        "api.dfg", "api.agent_api", "api.env_api", "api.cli_args",
        "api.model_api", "api.data", "base.topology", "base.seeding",
        "base.monitor", "base.metrics", "base.stats_tracker",
        "base.timeutil", "base.recover", "models.quantize",
        "system.request_reply_stream", "system.push_pull_stream",
        "system.stream_dataset", "system.redistributor",
        "system.data_manager", "system.buffer", "system.function_executor",
        "system.master_worker", "system.model_worker",
        "system.gserver_manager", "system.partial_rollout",
        "system.rollout_worker", "observability.aggregator",
        "observability.trace_collector", "observability.prom_text",
        "gateway.admission", "agents.math_single_step_agent",
        "envs.math_code_single_step_env", "verifiers.dispatch",
        "verifiers.math_verify", "data.math_parser", "data.math_code_dataset",
        "experiments.common", "experiments.ppo_math_exp",
        "experiments.async_ppo_exp", "apps.local_runner",
        "apps.main_async_ppo",
    )
]


#: the HF checkpoint import/export modules
HF_MODULES = [
    f"areal_tpu_torch.models.hf{m}"
    for m in ("", ".registry", ".llama_like", ".gpt2")
]

#: the launcher's modules: one process per worker, the scheduler clients,
#: the name-resolve service
LAUNCH_MODULES = [
    f"areal_tpu_torch.{m}" for m in (
        "apps.main", "apps.remote", "apps.quickstart", "scheduler",
        "scheduler.client", "scheduler.slurm", "base.name_resolve_server",
        "base.watchdog",
    )
]

#: sync PPO's modules: generation over the dense KV cache, the critic, the
#: reference and reward models, the fused interface, the entry point
SYNC_MODULES = [
    f"areal_tpu_torch.{m}" for m in (
        "engine.generation", "models.transformer", "models.convert",
        "models.config", "interfaces.ppo_functional",
        "interfaces.ppo_interface", "interfaces.rw_interface",
        "interfaces.fused_interface", "interfaces.rm_interface",
        "apps.main_sync_ppo", "tools.sync_rehearsal",
    )
]

#: the rest of the training surface: SFT, DPO, reward-model and null
#: experiments, their datasets and interfaces, the optimizer options, the
#: remat policies and the card-only tool that times the flash kernels
TRAINING_MODULES = [
    f"areal_tpu_torch.{m}" for m in (
        "data", "data.prompt_answer_dataset", "data.rw_paired_dataset",
        "data.prompt_dataset", "data.preprocess", "ops.dpo",
        "interfaces.sft_interface", "interfaces.dpo_interface",
        "interfaces.null_interface", "experiments.sft_exp",
        "experiments.dpo_exp", "experiments.rm_exp", "experiments.null_exp",
        "apps.main_sft", "apps.main_dpo", "engine.optimizer",
        "engine.train_engine", "models.remat", "tools.training_rehearsal",
        "tools.flash_ab",
    )
]


#: the serving features' modules: speculative decoding, the prefix cache's
#: host tier, the paged and dense forwards, int8 serving weights, the
#: kernels' wrappers they call and the card-only tools that measure them
SERVING_FEATURE_MODULES = [
    f"areal_tpu_torch.{m}" for m in (
        "engine.spec_decode", "engine.prefix_cache", "engine.dispatch",
        "engine.batching", "engine.sampling", "models.paged",
        "ops.paged_attention", "ops.decode_attention",
        "tools.features_rehearsal", "tools.w8_controls",
    )
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_no_jax_and_no_reference_package_imported():
    code = (
        "import importlib, pkgutil, sys\n"
        "import areal_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "areal_tpu_torch.__path__, 'areal_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' "
        "or k.startswith(('jax.', 'jaxlib', 'areal_tpu.')) or k == 'areal_tpu')\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 12, mods\n"
        f"missing = sorted(set("
        f"{sorted(SERVING_MODULES + LOOP_MODULES + HF_MODULES + LAUNCH_MODULES + SYNC_MODULES + TRAINING_MODULES + SERVING_FEATURE_MODULES)!r}) "
        "- set(mods))\n"
        "assert not missing, missing\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr


def _imports(path: Path):
    """Every module name a source file imports, at module level or inside
    a function (the walk above only sees what importing runs)."""
    import ast

    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.append(node.module)
    return out


@pytest.mark.parametrize("module", LOOP_MODULES + SERVING_MODULES + HF_MODULES
                         + LAUNCH_MODULES + SYNC_MODULES + TRAINING_MODULES
                         + SERVING_FEATURE_MODULES)
def test_no_module_imports_jax_or_the_reference_anywhere(module):
    rel = module.replace(".", "/")
    path = REPO / f"{rel}.py"
    if not path.exists():
        path = REPO / rel / "__init__.py"
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "optax", "orbax", "flax",
                                  "areal_tpu")]
    assert not bad, (module, bad)


def test_host_worker_processes_never_initialize_cuda(tmp_path):
    """On a machine with a card (``torch.cuda.is_available()`` made True),
    the master's, the gserver manager's and the rollout workers' paths of
    ``apps.remote`` import, build their workers and, for the master,
    configure it and take a sample of its utilization monitor, without
    initializing CUDA (``torch.cuda``'s initialization made to raise): only
    the model workers and the generation servers hold the card."""
    code = (
        "import torch\n"
        "def boom(*a, **k):\n"
        "    raise AssertionError('CUDA initialized')\n"
        "torch.cuda._lazy_init = boom\n"
        "torch.cuda.init = boom\n"
        "torch.cuda.is_available = lambda: True\n"
        "torch.cuda.device_count = lambda: 1\n"
        "from areal_tpu_torch.apps import remote\n"
        "from areal_tpu_torch.apps.local_runner import register_impls\n"
        "from areal_tpu_torch.api.system_api import MasterWorkerConfig\n"
        "from areal_tpu_torch.base import constants, name_resolve\n"
        "register_impls()\n"
        "name_resolve.reconfigure('memory')\n"
        "constants.set_experiment_trial_names('iso', 'host')\n"
        "workers = {t: remote.worker_class(t)() for t in\n"
        "           ('master', 'gserver_manager', 'rollout_worker')}\n"
        "m = workers['master']\n"
        "m._configure(MasterWorkerConfig())\n"
        "m._util_monitor._sample()\n"
        "assert not any(k.startswith('device') for k in\n"
        "               m._util_monitor.export()), m._util_monitor.export()\n"
        "m._exit_hook()\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO),
               AREAL_LOG_ROOT=str(tmp_path / "logs"))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), (
        out.stdout[-2000:] + out.stderr[-4000:])


def test_launcher_refuses_what_it_does_not_port(monkeypatch):
    """A worker spread over several processes (item 10) and the gateway
    worker (item 16) are refused by name."""
    from areal_tpu_torch.apps import remote

    with pytest.raises(NotImplementedError, match="item 16"):
        remote.worker_class("gateway")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="item 10"):
        remote.run_worker("e", "t", "master", 0)


def test_loop_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """The model worker resolves its device at configure time: ``cuda``
    unless its config asks for the CPU, and no CUDA device raises."""
    from areal_tpu_torch.api.system_api import ModelWorkerConfig
    from areal_tpu_torch.base import constants, name_resolve
    from areal_tpu_torch.experiments.async_ppo_exp import (
        AsyncPPOMathExperiment,
    )
    from areal_tpu_torch.system.model_worker import ModelWorker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    name_resolve.reconfigure("memory")
    constants.set_experiment_trial_names("isolation", "loop")
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelWorker()._configure(ModelWorkerConfig(worker_name="mw"))
    exp = AsyncPPOMathExperiment()
    assert exp.worker_device() is None
    exp.force_cpu_devices = 1
    assert exp.worker_device() == "cpu"


@pytest.mark.parametrize(
    "kw,what",
    [
        (dict(agent_type="math-multi-turn"), "multi-turn"),
        (dict(allocation_mode="d2m1"), "item 10"),
        (dict(force_cpu_devices=2), "item 10"),
    ],
    ids=["multi_turn", "allocation", "cpu_devices"],
)
def test_loop_refuses_what_it_does_not_port(kw, what):
    from areal_tpu_torch.api.config import ModelAbstraction
    from areal_tpu_torch.experiments.async_ppo_exp import (
        AsyncPPOMathExperiment,
    )
    from areal_tpu_torch.experiments.ppo_math_exp import PPOHyperparameters

    kw = dict(kw)
    ppo = dict(disable_value=True, kl_ctl=0.0)
    ppo.update(kw.pop("ppo", {}))
    exp = AsyncPPOMathExperiment(
        actor=ModelAbstraction("random", {}), ppo=PPOHyperparameters(**ppo),
        **kw)
    with pytest.raises(NotImplementedError, match=what):
        exp.initial_setup()


@pytest.mark.parametrize(
    "call,what",
    [
        (lambda: __import__("areal_tpu_torch.base.topology",
                            fromlist=["x"]).MeshSpec(data=2).make_mesh(),
         "item 10"),
        (lambda: __import__("areal_tpu_torch.verifiers.dispatch",
                            fromlist=["x"]).verify_batch(
            ["code"], ["print(1)"], [{"query_id": "q"}]), "item 15"),
        (lambda: __import__("areal_tpu_torch.api.system_api",
                            fromlist=["x"]).ExperimentConfig(
            "e", "t", master=__import__(
                "areal_tpu_torch.api.system_api",
                fromlist=["x"]).MasterWorkerConfig(),
            gateway=object()).lazy_init(), "item 16"),
    ],
    ids=["mesh", "code_verifier", "gateway"],
)
def test_loop_parts_out_of_the_slice_are_refused(call, what):
    with pytest.raises(NotImplementedError, match=what):
        call()


def _tiny_engine_args():
    cfg = tiny_config(vocab_size=32)
    return cfg, init_params(cfg, 0, torch.device("cpu"))


def test_engine_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, params = _tiny_engine_args()
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatchingEngine(cfg, params, kv_cache_len=64,
                                 cache_mode="paged", page_size=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({}, cfg)
    master = init_params(cfg, 0, torch.device("cpu"), dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainEngine(cfg, None, master)
    assert TrainEngine(cfg, None, master, device="cpu").device.type == "cpu"
    # an explicit CPU request is honoured
    eng = ContinuousBatchingEngine(cfg, params, kv_cache_len=64,
                                   cache_mode="paged", page_size=16,
                                   device="cpu")
    assert eng.k_pool.device.type == "cpu"


def test_kernel_wrapper_never_falls_back(monkeypatch):
    B, Q, Hq, Hkv, hd, NB, BS, MB = 2, 1, 4, 2, 128, 4, 16, 2
    meta = dict(device="meta")
    args = (
        torch.empty((B, Q, Hq, hd), **meta),
        torch.empty((NB, Hkv, BS, hd), **meta),
        torch.empty((NB, Hkv, BS, hd), **meta),
        torch.empty((B, MB), dtype=torch.int32, **meta),
        torch.empty((B,), dtype=torch.int32, **meta),
    )
    # a tensor off the CPU goes to the kernel path, which refuses it
    with pytest.raises(RuntimeError, match="CUDA"):
        tpa.paged_flash_attention(*args)
    assert tpa.paged_flash_attention.launches == 0
    # the kernel library refuses to build or load without a card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _build.load_library.cache_clear()
    with pytest.raises(RuntimeError, match="CUDA device"):
        _build.load_library("paged_attention")


def test_new_kernel_wrappers_never_fall_back():
    """The deep paged kernel, the int8 branch and flash_decode: a tensor
    off the CPU goes to the kernel path, which refuses it here."""
    B, Q, Hq, Hkv, hd, NB, BS, MB = 2, 1, 4, 2, 128, 4, 16, 2
    meta = dict(device="meta")
    q = torch.empty((B, Q, Hq, hd), **meta)
    pools = [torch.empty((NB, Hkv, BS, hd), **meta) for _ in range(2)]
    i8 = [torch.empty((NB, Hkv, BS, hd), dtype=torch.int8, **meta)
          for _ in range(2)]
    scales = [torch.empty((NB, Hkv, BS), **meta) for _ in range(2)]
    tables = torch.empty((B, MB), dtype=torch.int32, **meta)
    lengths = torch.empty((B,), dtype=torch.int32, **meta)
    for fn in (tpa.paged_flash_attention, tpa.paged_flash_attention_deep):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(q, *pools, tables, lengths)
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(q, *i8, tables, lengths, *scales)
        assert fn.launches == 0 and fn.int8_launches == 0
    with pytest.raises(RuntimeError, match="CUDA"):
        tda.flash_decode(q[:, 0], torch.empty((B, Hkv, 64, hd), **meta),
                         torch.empty((B, Hkv, 64, hd), **meta), lengths)
    assert tda.flash_decode.launches == 0


def test_kernel_args_are_checked():
    """What the kernels do not take is refused before any launch: an
    int8 pool without scales, scales with an fp pool, mismatched scale
    shapes."""
    B, Q, Hq, Hkv, hd, NB, BS, MB = 2, 1, 4, 2, 128, 4, 16, 2
    q = torch.zeros((B, Q, Hq, hd), dtype=torch.bfloat16)
    i8 = torch.zeros((NB, Hkv, BS, hd), dtype=torch.int8)
    bf = torch.zeros((NB, Hkv, BS, hd), dtype=torch.bfloat16)
    sc = torch.zeros((NB, Hkv, BS))
    tables = torch.zeros((B, MB), dtype=torch.int32)
    lengths = torch.zeros((B,), dtype=torch.int32)
    tpa.check_args(q, bf, bf, tables, lengths, None, None)
    tpa.check_args(q, i8, i8, tables, lengths, sc, sc)
    for pools, scales in (
        ((i8, i8), (None, None)),
        ((bf, bf), (sc, sc)),
        ((i8, i8), (sc, None)),
        ((i8, i8), (sc[:, :, :8], sc[:, :, :8])),
        ((i8, i8), (sc.double(), sc.double())),
    ):
        with pytest.raises(ValueError):
            tpa.check_args(q, *pools, tables, lengths, *scales)


def test_kernel_source_targets_hopper():
    for name, entry in (("paged_attention", "paged_attention_fwd"),
                        ("paged_attention_deep", "paged_attention_deep_fwd"),
                        ("paged_attention_deep", "flash_decode_fwd")):
        src = (REPO / f"areal_tpu_torch/csrc/{name}.cu").read_text()
        assert entry in src
    assert "arch=compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)


@pytest.mark.parametrize(
    "kw",
    [
        dict(prefix_cache=True, prefix_cache_host_bytes=1 << 20),
        dict(serving_weight_dtype="int8"),
        dict(spec_decode_params=SpecDecodeParams(enabled=True)),
        dict(handoff_streaming=True),
        dict(mesh=object()),
        dict(cache_mode="dense"),
    ],
    ids=lambda kw: next(iter(kw)),
)
def test_out_of_slice_options_are_refused(kw):
    """P/D handoff streaming (item 8) and meshes (item 10) are refused; the
    host tier, int8 weights, speculative decoding and the dense cache are
    served and hold what was asked for."""
    cfg, params = _tiny_engine_args()

    def make(**more):
        return ContinuousBatchingEngine(
            cfg, params, max_batch=2, kv_cache_len=128, page_size=16,
            device="cpu", **dict(dict(cache_mode="paged"), **kw, **more),
        )

    key = next(iter(kw))
    if key in ("handoff_streaming", "mesh"):
        with pytest.raises(NotImplementedError,
                           match="item 8" if key == "handoff_streaming"
                           else "item 10"):
            make()
    elif key == "prefix_cache":
        stats = make().prefix_cache_stats()
        assert stats["host_bytes_budget"] == 1 << 20
    elif key == "serving_weight_dtype":
        assert make().weight_quant_stats()["quantized"] == 1
    elif key == "spec_decode_params":
        # exact under greedy sampling only, as in the reference
        assert make()._spec is None
        assert make(sampling=SamplingParams(greedy=True))._spec is not None
    else:
        assert not make().paged


def test_moe_config_is_refused():
    with pytest.raises(NotImplementedError):
        tiny_config(n_experts=4)


def test_small_pool_and_prefix_cache_are_served():
    """A pool below ``max_batch * kv_cache_len`` builds (the engine
    reclaims and preempts under pressure), and the radix prefix cache is
    on by default, as in the reference engine."""
    cfg, params = _tiny_engine_args()
    eng = ContinuousBatchingEngine(
        cfg, params, max_batch=2, kv_cache_len=128, page_size=16,
        device="cpu", cache_mode="paged", kv_pool_tokens=64,
    )
    # 64 tokens are 4 blocks of 16; one full-length row (8 blocks) fits
    assert eng.n_blocks == 8 and eng.free_pool_blocks == 8
    assert eng.prefix_cache_stats()["capacity_blocks"] == 4


def test_slo_tracking_is_accepted_and_default():
    """The SLO plane is ported: ``slo_tracking=True`` is the default, as in
    the reference engine, and an engine built with it keeps records."""
    import inspect

    sig = inspect.signature(ContinuousBatchingEngine.__init__)
    assert sig.parameters["slo_tracking"].default is True
    cfg, params = _tiny_engine_args()
    eng = ContinuousBatchingEngine(
        cfg, params, max_batch=2, kv_cache_len=128, page_size=16,
        device="cpu", cache_mode="paged", slo_tracking=True)
    assert eng.slo_stats()["records_total"] == 0


def test_server_entry_points_default_to_cuda(monkeypatch):
    """The model factory and the server's engine run on ``cuda`` unless the
    config asks for the CPU."""
    from areal_tpu_torch.api.config import ModelAbstraction
    from areal_tpu_torch.api.system_api import GenServerConfig
    from areal_tpu_torch.engine.backend import make_model
    from areal_tpu_torch.system.generation_server import GenerationServerWorker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    abs_ = ModelAbstraction("random", {"vocab_size": 32})
    with pytest.raises(RuntimeError, match="CUDA"):
        make_model(abs_, None)
    assert make_model(abs_, None, device="cpu").init_params[
        "embed"]["weight"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        GenerationServerWorker().configure(GenServerConfig(
            worker_name="gs", model=abs_, kv_cache_len=128,
            cache_mode="paged", page_size=16))
